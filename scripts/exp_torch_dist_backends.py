"""Check the collectives the port's multi-device paths use, on each backend
``parallel.dist.spawn`` can pick on this machine.

    python3 scripts/exp_torch_dist_backends.py [--device cpu]

On a card: one NCCL rank on ``cuda:0``, then four gloo ranks sharing
``cuda:0`` (what a one-card machine runs). Each rank builds a 1D and a 2D
``DeviceMesh`` (``make_mesh``, ``make_mesh_2d``, ``make_pod_mesh``) and runs
``all_reduce``, ``all_gather`` (list form), ``all_to_all_single`` with
uneven splits (one rank sending nothing to another) and ``broadcast`` on
tensors of its device, checking every result against the value it must
have. The port's helpers move nothing over a size-1 axis, so the
all_reduce checks and the 16 MB all_reduce timing call the backend
directly: one NCCL rank runs a real NCCL all_reduce. Prints one line per
backend and exits non-zero on any mismatch.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from nerf_vo_tpu_torch.parallel import dist as pdist  # noqa: E402


def check(rank, world, device):
    out = {}
    mesh = pdist.make_mesh()
    ax = pdist.mesh_axis(mesh, "data")
    assert (ax.size, ax.index) == (world, rank), (ax, rank)
    t = torch.full((1000,), float(rank + 1), device=device)
    dist.all_reduce(t)
    assert torch.all(t == world * (world + 1) / 2), t[:4]
    out["all_reduce"] = True
    g = pdist.all_gather_cat(torch.full((3, 2), float(rank), device=device),
                             ax)
    want = torch.arange(world, device=device).float().repeat_interleave(3)
    assert torch.equal(g[:, 0], want), g
    out["all_gather"] = True
    # uneven splits: rank r sends (r + j) % 3 rows to rank j (0 rows too)
    send = torch.tensor([(rank + j) % 3 for j in range(world)],
                        dtype=torch.int64, device=device)
    recv = pdist.exchange_counts(send, ax)
    assert recv.tolist() == [(j + rank) % 3 for j in range(world)], recv
    rows = torch.cat([torch.full((int(n), 5), 100.0 * rank + j,
                                 device=device)
                      for j, n in enumerate(send.tolist())])
    got = pdist.all_to_all_rows(rows, send.tolist(), recv.tolist(), ax)
    want = torch.cat([torch.full((int(n), 5), 100.0 * j + rank,
                                 device=device)
                      for j, n in enumerate(recv.tolist())])
    assert torch.equal(got, want), (got, want)
    out["all_to_all_uneven"] = True
    b = torch.full((7,), float(rank), device=device)
    dist.broadcast(b, src=0)
    assert torch.all(b == 0)
    out["broadcast"] = True
    if world % 2 == 0:
        m2 = pdist.make_mesh_2d(world // 2, 2)
        pod = pdist.make_pod_mesh(n_model=2)
        assert m2.mesh.tolist() == pod.mesh.tolist()
        d, m = pdist.mesh_axis(m2, "data"), pdist.mesh_axis(m2, "model")
        assert (d.index, m.index) == (rank // 2, rank % 2), (d, m)
        s = torch.full((4,), float(rank), device=device)
        pdist.all_reduce_sum(s, m)
        assert torch.all(s == 2 * (rank // 2) * 2 + 1), s
        out["mesh_2d"] = True
    t0 = time.perf_counter()
    big = torch.ones(1 << 22, device=device)
    for _ in range(5):
        dist.all_reduce(big)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    out["all_reduce_16MB_ms"] = (time.perf_counter() - t0) / 5 * 1e3
    out["device"] = str(device)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    cases = [(1, None), (4, None)]
    if torch.device(a.device).type == "cuda":
        print(torch.cuda.get_device_name(0), flush=True)
    for world, backend in cases:
        res = pdist.spawn(check, world, a.device, backend, timeout=300)
        print(f"world {world}: {res[0]}", flush=True)
    print("ok", flush=True)


if __name__ == "__main__":
    main()
