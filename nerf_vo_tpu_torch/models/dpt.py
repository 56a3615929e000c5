"""DPT (Dense Prediction Transformer) ViT-hybrid depth/normal network.

Counterpart of ``nerf_vo_tpu/models/dpt.py`` (Omnidata's ``DPTDepthModel``
with ``backbone='vitb_rn50_384'``). The modules carry the Omnidata torch key
layout (``pretrained.model.*``, ``pretrained.act_postprocess{3,4}.*``,
``scratch.*``), so an Omnidata checkpoint loads through
:func:`load_torch_weights` (as the JAX package's loader reads it), and
:func:`from_jax_params` maps the JAX package's Flax params onto it.

  * backbone: a ResNetV2 stem — weight-standardized convs (eps 1e-8) +
    GroupNorm(32) + ReLU, TF-SAME padding, stages (3, 4, 9) with widths
    256/512/1024 — then a 1x1 patch embedding, cls token + position
    embedding, and pre-norm transformer blocks (fused qkv, 12 heads, GELU
    MLP x4).
  * decoder: taps at ResNet stages 0 and 1 and at two transformer blocks
    (``hooks``); project readout; ``act_postprocess``; 3x3 projections to
    ``features``; four fusion blocks with x2 align-corners upsampling; and
    the output head.

The model keeps f32 parameters; with ``dtype=torch.bfloat16`` its forward
runs under autocast (bf16 convolutions and matmuls, f32 normalization), as
the JAX model computes in bf16. Input [B, S, S, 3], output [B, S, S, C]
(channels-last, the JAX package's layout), ReLU-ed; the caller clamps.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def _pad_same(x, k: int, s: int, value: float = 0.0):
    """TF-SAME padding of an NCHW tensor for kernel k and stride s."""
    ih, iw = x.shape[-2:]
    ph = max((-(-ih // s) - 1) * s + k - ih, 0)
    pw = max((-(-iw // s) - 1) * s + k - iw, 0)
    return F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2),
                 value=value)


def resize_align_corners(x, h2: int, w2: int):
    """[B, C, H, W] bilinear resize with align_corners=True."""
    return F.interpolate(x, size=(h2, w2), mode="bilinear",
                         align_corners=True)


class StdConv2dSame(nn.Conv2d):
    """Weight-standardized conv (timm StdConv2dSame): per output channel
    over (in, kh, kw), biased variance, eps 1e-8; TF-SAME padding."""

    def __init__(self, cin, cout, k, stride=1):
        super().__init__(cin, cout, k, stride=stride, bias=False)

    def forward(self, x):
        v, m = torch.var_mean(self.weight, dim=[1, 2, 3], keepdim=True,
                              unbiased=False)
        w = (self.weight - m) / torch.sqrt(v + 1e-8)
        x = _pad_same(x, self.kernel_size[0], self.stride[0])
        return F.conv2d(x, w, None, self.stride, 0)


class GroupNormAct(nn.GroupNorm):
    """GroupNorm(32) + optional ReLU (timm GroupNormAct)."""

    def __init__(self, ch, act=True):
        super().__init__(32, ch, eps=1e-5)
        self.act = act

    def forward(self, x):
        x = super().forward(x)
        return F.relu(x) if self.act else x


class _Downsample(nn.Module):
    def __init__(self, cin, cout, stride):
        super().__init__()
        self.conv = StdConv2dSame(cin, cout, 1, stride)
        self.norm = GroupNormAct(cout, act=False)

    def forward(self, x):
        return self.norm(self.conv(x))


class Bottleneck(nn.Module):
    """timm ResNetV2 (non-preact) bottleneck."""

    def __init__(self, cin, mid, cout, stride=1):
        super().__init__()
        self.downsample = (
            _Downsample(cin, cout, stride)
            if stride != 1 or cin != cout else None
        )
        self.conv1 = StdConv2dSame(cin, mid, 1)
        self.norm1 = GroupNormAct(mid)
        self.conv2 = StdConv2dSame(mid, mid, 3, stride)
        self.norm2 = GroupNormAct(mid)
        self.conv3 = StdConv2dSame(mid, cout, 1)
        self.norm3 = GroupNormAct(cout, act=False)

    def forward(self, x):
        shortcut = x if self.downsample is None else self.downsample(x)
        x = self.norm1(self.conv1(x))
        x = self.norm2(self.conv2(x))
        x = self.norm3(self.conv3(x))
        return F.relu(x + shortcut)


class _Stage(nn.Module):
    def __init__(self, cin, mid, cout, n, stride):
        super().__init__()
        blocks = [Bottleneck(cin, mid, cout, stride)]
        blocks += [Bottleneck(cout, mid, cout, 1) for _ in range(n - 1)]
        self.blocks = nn.Sequential(*blocks)

    def forward(self, x):
        return self.blocks(x)


class _Stem(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = StdConv2dSame(3, 64, 7, 2)
        self.norm = GroupNormAct(64)


class ResNetV2Backbone(nn.Module):
    """Stem + stages (3, 4, 9); taps after stage 0 (1/4, 256) and stage 1
    (1/8, 512); output at 1/16, 1024."""

    def __init__(self):
        super().__init__()
        self.stem = _Stem()
        self.stages = nn.ModuleList([
            _Stage(64, 64, 256, 3, 1),
            _Stage(256, 128, 512, 4, 2),
            _Stage(512, 256, 1024, 9, 2),
        ])

    def forward(self, x):
        x = self.stem.norm(self.stem.conv(x))
        x = F.max_pool2d(_pad_same(x, 3, 2, value=-torch.inf), 3, 2)
        taps = []
        for i, stage in enumerate(self.stages):
            x = stage(x)
            if i < 2:
                taps.append(x)
        return taps[0], taps[1], x


class Attention(nn.Module):
    def __init__(self, dim, heads=12):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, N, D = x.shape
        hd = D // self.heads
        q, k, v = self.qkv(x).reshape(B, N, 3, self.heads, hd).permute(
            2, 0, 3, 1, 4)
        att = torch.softmax((q @ k.transpose(-2, -1)) * hd ** -0.5, dim=-1)
        return self.proj((att @ v).transpose(1, 2).reshape(B, N, D))


class Mlp(nn.Module):
    def __init__(self, dim, ratio=4):
        super().__init__()
        self.fc1 = nn.Linear(dim, dim * ratio)
        self.fc2 = nn.Linear(dim * ratio, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class _PatchEmbed(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.backbone = ResNetV2Backbone()
        self.proj = nn.Conv2d(1024, dim, 1)


class VitHybrid(nn.Module):
    def __init__(self, dim, depth, grid):
        super().__init__()
        self.patch_embed = _PatchEmbed(dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(
            torch.randn(1, grid * grid + 1, dim) * 0.02)
        self.blocks = nn.ModuleList([Block(dim) for _ in range(depth)])


class ProjectReadout(nn.Module):
    """cat(spatial tokens, broadcast cls) -> Linear(2*dim, dim) -> GELU."""

    def __init__(self, dim):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * dim, dim), nn.GELU())

    def forward(self, tokens):
        cls = tokens[:, :1].expand_as(tokens[:, 1:])
        return self.project(torch.cat([tokens[:, 1:], cls], -1))


class ResidualConvUnit(nn.Module):
    """x + conv(relu(conv(relu(x))))."""

    def __init__(self, f):
        super().__init__()
        self.conv1 = nn.Conv2d(f, f, 3, padding=1)
        self.conv2 = nn.Conv2d(f, f, 3, padding=1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FeatureFusion(nn.Module):
    """(+ rcu1(skip)), rcu2, x2 align-corners upsample, 1x1 out conv."""

    def __init__(self, f):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(f)
        self.resConfUnit2 = ResidualConvUnit(f)
        self.out_conv = nn.Conv2d(f, f, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        x = resize_align_corners(x, x.shape[-2] * 2, x.shape[-1] * 2)
        return self.out_conv(x)


class _Pretrained(nn.Module):
    def __init__(self, dim, depth, grid):
        super().__init__()
        self.model = VitHybrid(dim, depth, grid)
        # indices 1-2 are upstream's parameter-free transpose / unflatten
        self.act_postprocess3 = nn.Sequential(
            ProjectReadout(dim), nn.Identity(), nn.Identity(),
            nn.Conv2d(dim, dim, 1),
        )
        self.act_postprocess4 = nn.Sequential(
            ProjectReadout(dim), nn.Identity(), nn.Identity(),
            nn.Conv2d(dim, dim, 1),
            nn.Conv2d(dim, dim, 3, stride=2, padding=1),
        )


class _Scratch(nn.Module):
    def __init__(self, dim, features, num_channels):
        super().__init__()
        self.layer1_rn = nn.Conv2d(256, features, 3, padding=1, bias=False)
        self.layer2_rn = nn.Conv2d(512, features, 3, padding=1, bias=False)
        self.layer3_rn = nn.Conv2d(dim, features, 3, padding=1, bias=False)
        self.layer4_rn = nn.Conv2d(dim, features, 3, padding=1, bias=False)
        self.refinenet1 = FeatureFusion(features)
        self.refinenet2 = FeatureFusion(features)
        self.refinenet3 = FeatureFusion(features)
        self.refinenet4 = FeatureFusion(features)
        # indices 1, 5, 6: upstream's interpolate / final ReLU / identity
        self.output_conv = nn.Sequential(
            nn.Conv2d(features, features // 2, 3, padding=1), nn.Identity(),
            nn.Conv2d(features // 2, 32, 3, padding=1), nn.ReLU(),
            nn.Conv2d(32, num_channels, 3, padding=1), nn.ReLU(),
            nn.Identity(),
        )


class DPTHybrid(nn.Module):
    """ViT-hybrid DPT: depth (1 channel) or normals (3) at input size."""

    def __init__(self, num_channels: int = 1, dim: int = 768,
                 depth_layers: int = 12, hooks: Tuple[int, int] = (8, 11),
                 features: int = 256, image_size: int = 384,
                 dtype=torch.bfloat16):
        super().__init__()
        self.hooks = tuple(hooks)
        self.dim = dim
        self.dtype = dtype
        self.pretrained = _Pretrained(dim, depth_layers, image_size // 16)
        self.scratch = _Scratch(dim, features, num_channels)

    def forward(self, images):
        """images: [B, S, S, 3] normalized -> [B, S, S, num_channels] f32."""
        B, H, W, _ = images.shape
        with torch.autocast(images.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            m = self.pretrained.model
            x = images.permute(0, 3, 1, 2)
            s1, s2, feat = m.patch_embed.backbone(x)
            t = m.patch_embed.proj(feat)
            hg, wg = t.shape[-2:]
            t = t.flatten(2).transpose(1, 2)
            t = torch.cat([m.cls_token.expand(B, -1, -1).to(t.dtype), t], 1)
            t = t + m.pos_embed
            taps = []
            for i, blk in enumerate(m.blocks):
                t = blk(t)
                if i in self.hooks:
                    taps.append(t)

            def tok2map(tok):
                return tok.transpose(1, 2).reshape(B, self.dim, hg, wg)

            p3, p4 = self.pretrained.act_postprocess3, \
                self.pretrained.act_postprocess4
            t3 = p3[3](tok2map(p3[0](taps[0])))
            t4 = p4[4](p4[3](tok2map(p4[0](taps[1]))))

            sc = self.scratch
            f4 = sc.refinenet4(sc.layer4_rn(t4))
            f3 = sc.refinenet3(f4, sc.layer3_rn(t3))
            f2 = sc.refinenet2(f3, sc.layer2_rn(s2))
            f1 = sc.refinenet1(f2, sc.layer1_rn(s1))
            oc = sc.output_conv
            h = resize_align_corners(oc[0](f1), H, W)
            out = oc[4](F.relu(oc[2](h)))
        return F.relu(out.float()).permute(0, 2, 3, 1)


# --------------------------------------------------------------------------
# Flax params -> state_dict (the inverse of the JAX convert_torch_checkpoint)
# --------------------------------------------------------------------------

def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _conv(sd, prefix, p):
    sd[prefix + ".weight"] = _t(np.transpose(np.asarray(p["kernel"]),
                                             (3, 2, 0, 1)))
    if "bias" in p:
        sd[prefix + ".bias"] = _t(p["bias"])


def _lin(sd, prefix, p):
    sd[prefix + ".weight"] = _t(np.asarray(p["kernel"]).T)
    sd[prefix + ".bias"] = _t(p["bias"])


def _norm(sd, prefix, p):
    sd[prefix + ".weight"] = _t(p["scale"])
    sd[prefix + ".bias"] = _t(p["bias"])


def _bottleneck(sd, prefix, p):
    for i in (1, 2, 3):
        _conv(sd, f"{prefix}.conv{i}", p[f"conv{i}"])
        _norm(sd, f"{prefix}.norm{i}", p[f"norm{i}"]["GroupNorm_0"])
    if "down_conv" in p:
        _conv(sd, prefix + ".downsample.conv", p["down_conv"])
        _norm(sd, prefix + ".downsample.norm", p["down_norm"]["GroupNorm_0"])


def _fusion(sd, prefix, p, features):
    for j in (1, 2):
        name = f"rcu{j}"
        if name in p:
            for c in ("conv1", "conv2"):
                _conv(sd, f"{prefix}.resConfUnit{j}.{c}", p[name][c])
        else:
            # refinenet4 never calls rcu1, so a Flax init has no params for
            # it; upstream checkpoints carry (unused) weights there
            for c in ("conv1", "conv2"):
                sd[f"{prefix}.resConfUnit{j}.{c}.weight"] = torch.zeros(
                    features, features, 3, 3)
                sd[f"{prefix}.resConfUnit{j}.{c}.bias"] = torch.zeros(
                    features)
    _conv(sd, prefix + ".out_conv", p["out_conv"])


def from_jax_params(params_np: Dict[str, Any],
                    num_channels: int) -> Dict[str, torch.Tensor]:
    """Map the JAX ``DPTHybrid`` Flax params (nested dicts of numpy arrays,
    with or without the outer ``"params"`` key) onto this module's
    Omnidata-layout state_dict. ``num_channels`` must match the head."""
    p = params_np.get("params", params_np)
    head = np.asarray(p["head_out"]["kernel"])
    if head.shape[-1] != num_channels:
        raise ValueError(f"params head has {head.shape[-1]} channels, "
                         f"expected {num_channels}")
    sd: Dict[str, torch.Tensor] = {}
    bb = "pretrained.model.patch_embed.backbone"
    _conv(sd, bb + ".stem.conv", p["stem"]["stem_conv"])
    _norm(sd, bb + ".stem.norm", p["stem"]["stem_norm"]["GroupNorm_0"])
    for s, nblocks in enumerate((3, 4, 9)):
        for b in range(nblocks):
            _bottleneck(sd, f"{bb}.stages.{s}.blocks.{b}",
                        p["stem"][f"stage{s}_block{b}"])
    _conv(sd, "pretrained.model.patch_embed.proj", p["patch_embed"])
    sd["pretrained.model.cls_token"] = _t(p["cls_token"])
    sd["pretrained.model.pos_embed"] = _t(p["pos_embed"])
    n_blocks = sum(1 for k in p if k.startswith("block_"))
    for i in range(n_blocks):
        blk, pre = p[f"block_{i}"], f"pretrained.model.blocks.{i}"
        _norm(sd, pre + ".norm1", blk["norm1"])
        _lin(sd, pre + ".attn.qkv", blk["attn"]["qkv"])
        _lin(sd, pre + ".attn.proj", blk["attn"]["proj"])
        _norm(sd, pre + ".norm2", blk["norm2"])
        _lin(sd, pre + ".mlp.fc1", blk["fc1"])
        _lin(sd, pre + ".mlp.fc2", blk["fc2"])
    _lin(sd, "pretrained.act_postprocess3.0.project.0",
         p["readout3"]["project"])
    _conv(sd, "pretrained.act_postprocess3.3", p["post3_conv"])
    _lin(sd, "pretrained.act_postprocess4.0.project.0",
         p["readout4"]["project"])
    _conv(sd, "pretrained.act_postprocess4.3", p["post4_conv"])
    _conv(sd, "pretrained.act_postprocess4.4", p["post4_down"])
    features = np.asarray(p["layer1_rn"]["kernel"]).shape[-1]
    for n in range(1, 5):
        _conv(sd, f"scratch.layer{n}_rn", p[f"layer{n}_rn"])
        _fusion(sd, f"scratch.refinenet{n}", p[f"refinenet{n}"], features)
    _conv(sd, "scratch.output_conv.0", p["head_c1"])
    _conv(sd, "scratch.output_conv.2", p["head_c2"])
    _conv(sd, "scratch.output_conv.4", p["head_out"])
    return sd


# --------------------------------------------------------------------------
# Omnidata checkpoint -> state_dict (the JAX convert_torch_checkpoint)
# --------------------------------------------------------------------------

def convert_checkpoint(state_dict: Dict[str, Any], num_channels: int,
                       depth_layers: int = 12) -> Dict[str, torch.Tensor]:
    """An Omnidata ``DPTDepthModel`` state dict -> :class:`DPTHybrid`'s at
    ``depth_layers`` blocks, read as the JAX ``convert_torch_checkpoint``
    reads it: a leading ``model.`` (the Lightning dump's) stripped; every
    key that converter reads must be there (all 12 transformer blocks and
    ``refinenet4``'s ``resConfUnit1``, which the forward never calls), and
    the head conv must have ``num_channels`` outputs; keys it never reads
    (``pretrained.act_postprocess{1,2}.*``, the timm ViT's ``norm`` and
    ``head``) are dropped. A model cut to fewer blocks keeps the file's
    first ``depth_layers``, as the JAX model reads only those.

    Raises ``KeyError`` naming a missing key, ``ValueError`` on the head.
    """
    sd = {(k[6:] if k.startswith("model.") else k): torch.as_tensor(v)
          for k, v in state_dict.items()}
    with torch.device("meta"):
        needed = DPTHybrid(num_channels).state_dict()  # all 12 blocks
    for k in needed:
        if k not in sd:
            raise KeyError(f"omnidata checkpoint has no {k!r}")
    head = sd["scratch.output_conv.4.weight"].shape[0]
    if head != num_channels:
        raise ValueError(f"checkpoint head has {head} channels, "
                         f"model expects {num_channels}")
    return {k: sd[k] for k in needed
            if not (k.startswith("pretrained.model.blocks.")
                    and int(k.split(".")[3]) >= depth_layers)}


def load_torch_weights(path: str, num_channels: int,
                       depth_layers: int = 12) -> Dict[str, torch.Tensor]:
    """Load an Omnidata checkpoint from disk (a ``state_dict`` wrapper is
    unwrapped) as :class:`DPTHybrid`'s state dict; see
    :func:`convert_checkpoint`. ``NERF_VO_OMNIDATA_DEPTH_WEIGHTS`` /
    ``NERF_VO_OMNIDATA_NORMAL_WEIGHTS`` name the files for the enhancement
    stage."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    return convert_checkpoint(ckpt, num_channels, depth_layers)
