"""Bytes and operations of the hash grid's table kernels, from a call's own
inputs, whatever implements the call.

Frozen from ``chip_smoke.py``: ``live_groups`` and ``interp_table_bytes``
(chip_smoke.py:752-776), the per-descriptor terms that ``interp_entry``
adds (chip_smoke.py:856-871) and the byte and operation counts of
``scatter_cols_outer`` (chip_smoke.py:680-686). Each input byte is counted
read once and each output byte written once; a table row's bytes count
only where a descriptor needs them (a non-zero weight).
"""

from __future__ import annotations

import torch


def live_groups(t, i, w, F, group_bytes):
    """[m, 32F*size / group_bytes] bool: the groups of ``group_bytes`` bytes
    of each descriptor's table row that hold an entry with a non-zero
    weight (none for an id out of range)."""
    per = group_bytes // (t.element_size() * F)  # entries in a group
    ok = ((i >= 0) & (i < t.shape[0]))[:, None]
    return ((w != 0) & ok).reshape(i.shape[0], 32 // per, per).any(-1)


def interp_table_bytes(t, i, w, F) -> int:
    """Bytes of the table that gather_interp's function needs for these
    descriptors: of each touched brick, once, the 32-byte sectors (at F = 1
    the groups of 4 entries, 16 bytes in f32 and 8 in bf16) that hold an
    entry with a non-zero weight in some descriptor. Zero-weight entries,
    the padding entries 27..31 among them, are not needed."""
    group = 4 * t.element_size() if F == 1 else 32
    live = live_groups(t, i, w, F, group)
    G = live.shape[1]
    flat = (i.long().clamp(0, t.shape[0] - 1)[:, None] * G
            + torch.arange(G, device=i.device)[None, :])
    touched = torch.zeros(t.shape[0] * G, dtype=torch.bool, device=i.device)
    touched[flat[live]] = True
    return int(touched.sum()) * group


def gather_interp(t, i, w, F):
    """(bytes, operations) of ``gather_interp(t, i, w, F)``: the live table
    sectors, then each descriptor's id, weight row and F outputs; two
    operations a weight and feature."""
    m = i.shape[0]
    return (interp_table_bytes(t, i, w, F) + m * (4 + 32 * 4 + F * 4),
            2 * m * 32 * F)


def scatter_cols_outer(W, cot, idx, n_bricks):
    """(bytes, operations) of ``scatter_cols_outer(W, cot, idx, n_bricks)``:
    each descriptor's weight row, cotangent and id read, the whole
    [n_bricks, 32F] f32 gradient written; one multiply and one add a term.
    Its sort moves no byte the function needs, so its time counts against
    the same bound."""
    m, F = cot.shape
    return (m * (32 * 4 + 4 * F + 4) + n_bricks * 32 * F * 4,
            2 * m * 32 * F)
