"""Faults planted in the program's timed path, to show that the check of
``correct`` catches them (``calibrate.py`` on the card, ``tests/`` on the
CPU). Each is a context manager that patches the program while it is
open and restores it after.

- ``unchanged``: a train step that returns its state unchanged (no
  optimizer step; the step count still advances);
- ``half_batch``: half of the ray batch left out, the loss's means taken
  over the rest;
- ``altered``: an answer altered where it is produced: the hash grid's
  table gradient doubled as ``scatter_cols_outer`` returns it.

A one-card training cell has no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def unchanged():
    from nerf_vo_tpu_torch.mapping import trainer

    update = trainer.MappingTrainer.update

    def frozen(self, state, draws):
        for p in self.leaves(state):
            p.grad = None
        state.step += 1

    trainer.MappingTrainer.update = frozen
    try:
        yield
    finally:
        trainer.MappingTrainer.update = update


@contextlib.contextmanager
def half_batch():
    from nerf_vo_tpu_torch.models import nerfacto

    loss = nerfacto.NerfactoModel.loss

    def half(self, batch, uniforms=None, **kw):
        n = batch["origins"].shape[0] // 2
        batch = {k: (v[:n] if hasattr(v, "shape") and v.dim() and
                     v.shape[0] == 2 * n else v) for k, v in batch.items()}
        if uniforms is not None:
            uniforms = [u[:n] for u in uniforms]
        return loss(self, batch, uniforms, **kw)

    nerfacto.NerfactoModel.loss = half
    try:
        yield
    finally:
        nerfacto.NerfactoModel.loss = loss


@contextlib.contextmanager
def altered():
    from nerf_vo_tpu_torch.ops import gather_cuda as gc

    outer = gc.scatter_cols_outer

    def doubled(*a, **k):
        return 2.0 * outer(*a, **k)

    # the wrapper counts its launches on the function its module names
    doubled.launches = 0
    gc.scatter_cols_outer = doubled
    try:
        yield
    finally:
        outer.launches += doubled.launches
        gc.scatter_cols_outer = outer


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered": altered}
