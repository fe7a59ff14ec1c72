"""Bucketed payload transport (twin of ``src/repro/comm/bucket.py``,
DESIGN.md §11).

* :func:`build_bucket_plan` — a static plan over leaf shapes: each
  compressible leaf gets a :class:`LeafLane` (its (L, d) row geometry,
  :class:`~repro_torch.comm.wire.WireSpec` and word offset into ONE flat
  wire buffer); lanes sharing an index width form a :class:`Bucket`.
* :func:`encode_buckets` — per-leaf field construction (ragged lanes
  count-masked), ONE stream-pack launch per bucket field section, then
  the exact per-leaf payload rows back to back in one flat int32 buffer
  (no padding word on the wire).
* :func:`decode_buckets` — the inverse on the all-gathered (W, words)
  buffer, ONE stream-unpack launch per bucket field section, each ragged
  row read at its own header's count; the wire boundary of a fault
  campaign, and with ``with_verdicts`` the §16 verdict and quarantine
  (:func:`decode_guarded` takes them while the guards are on, as every
  transport decodes).  The plain kernels only: the ragged kernels are the
  per-leaf codec's (``comm/wire.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F_

from repro_torch.kernels import ops
from . import faults
from . import wire as wire_fmt
from .wire import WireSpec


def plan_geometry(shape: Sequence[int], stacked: bool) -> tuple[int, int]:
    """(L, d) per-layer row view of a leaf shape."""
    shape = tuple(shape)
    size = 1
    for s in shape:
        size *= s
    if stacked and len(shape) >= 2:
        return shape[0], size // shape[0]
    return 1, size


@dataclasses.dataclass(frozen=True)
class LeafLane:
    index: int                 # position in the flattened tree
    shape: tuple[int, ...]
    L: int
    d: int
    stacked: bool
    dense: bool                # ships uncompressed (all-reduce)
    spec: WireSpec | None = None
    word_off: int = 0

    @property
    def words(self) -> int:
        return 0 if self.dense else self.L * self.spec.row_words


@dataclasses.dataclass(frozen=True)
class Bucket:
    index_bits: int
    leaf_ids: tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    leaves: tuple[LeafLane, ...]
    buckets: tuple[Bucket, ...]
    total_words: int

    @property
    def compressed_ids(self) -> tuple[int, ...]:
        return tuple(ln.index for ln in self.leaves if not ln.dense)

    @property
    def dense_ids(self) -> tuple[int, ...]:
        return tuple(ln.index for ln in self.leaves if ln.dense)


def build_bucket_plan(shapes, stacked, comp) -> BucketPlan:
    lanes: list[LeafLane] = []
    by_bits: dict[int, list[int]] = {}
    word_off = 0
    for i, (shape, st) in enumerate(zip(shapes, stacked)):
        L, d = plan_geometry(shape, st)
        if comp.ships_dense(d):
            lanes.append(LeafLane(i, tuple(shape), L, d, st, True))
            continue
        spec = WireSpec.for_row(comp, d)
        lanes.append(LeafLane(i, tuple(shape), L, d, st, False, spec,
                              word_off))
        word_off += L * spec.row_words
        by_bits.setdefault(spec.index_bits, []).append(i)
    buckets = tuple(Bucket(bits, tuple(ids)) for bits, ids in by_bits.items())
    return BucketPlan(tuple(lanes), buckets, word_off)


def _pack_sections(group, bits: int):
    """One stream-pack launch for (leaf_id, (L, k) fields, words_per_row)
    sections -> {leaf_id: (L, words_per_row) words}."""
    streams, sizes = [], []
    F = max(1, 32 // bits)
    for _, fields, w in group:
        L, k = fields.shape
        pad = w * F - k
        if pad:
            fields = F_.pad(fields, (0, pad))
        streams.append(fields.reshape(-1))
        sizes.append(L * w)
    words = ops.pack_fields_stream(torch.cat(streams), bits)
    out, off = {}, 0
    for (leaf_id, fields, w), n in zip(group, sizes):
        out[leaf_id] = words[off:off + n].reshape(fields.shape[0], w)
        off += n
    return out


def _unpack_sections(group, bits: int):
    """(leaf_id, (R, w) words, k) groups -> {leaf_id: (R, k) fields}."""
    streams = [words.reshape(-1) for _, words, _ in group]
    fields = ops.unpack_fields_stream(torch.cat(streams), bits)
    F = max(1, 32 // bits)
    out, off = {}, 0
    for leaf_id, words, k in group:
        R, w = words.shape
        out[leaf_id] = fields[off:off + R * w * F].reshape(R, w * F)[:, :k]
        off += R * w * F
    return out


def encode_buckets(plan: BucketPlan, rows) -> torch.Tensor:
    """Encode every compressed leaf's (vals (L, k), idx (L, k), counts
    (L,) or None) — ``rows`` aligned with ``plan.leaves``, None for dense
    lanes — into the flat (total_words,) int32 wire buffer.  A ragged
    lane's field sections are count-masked here, before the one stream
    pack of its bucket (the per-leaf codec masks inside the ragged
    kernels; the fields are the same)."""
    secs = {}
    for ln in plan.leaves:
        if ln.dense:
            continue
        vals, idx, counts = rows[ln.index]
        header, ifields, vfields, counts = wire_fmt.row_fields(
            vals, idx, ln.spec, counts=counts)
        if ln.spec.ragged:
            valid = wire_fmt.field_mask(ln.spec.k, counts,
                                        ln.spec.count_period)
            ifields = torch.where(valid, ifields, 0)
            vfields = torch.where(valid, vfields, 0)
        secs[ln.index] = (header, ifields, vfields)

    lanes = {ln.index: ln for ln in plan.leaves}
    iwords: dict[int, torch.Tensor] = {}
    vwords: dict[int, torch.Tensor] = {}
    for b in plan.buckets:
        iwords.update(_pack_sections(
            [(i, secs[i][1], lanes[i].spec.index_words) for i in b.leaf_ids],
            b.index_bits))
        vwords.update(_pack_sections(
            [(i, secs[i][2], lanes[i].spec.value_words) for i in b.leaf_ids],
            lanes[b.leaf_ids[0]].spec.value_bits))

    segments = []
    for ln in plan.leaves:
        if ln.dense:
            continue
        header = secs[ln.index][0]
        parts = ([header] if header is not None else [])
        parts += [iwords[ln.index], vwords[ln.index]]
        segments.append(torch.cat(parts, dim=-1).reshape(-1))
    return torch.cat(segments)


def decode_buckets(plan: BucketPlan, gathered: torch.Tensor, *,
                   with_verdicts: bool = False):
    """Decode an all-gathered (W, total_words) buffer to per-leaf
    ((W, L, k) f32 values, (W, L, k) int32 flat indices) — a list aligned
    with ``plan.leaves``, None for dense lanes.

    This is the wire boundary: an active fault campaign
    (``comm/faults.py``) corrupts each lane's gathered rows here, before
    the unpack.  With ``with_verdicts`` a second aligned list of per-lane
    (W, L) bool verdicts is returned and invalid rows come back
    quarantined (value 0 at index 0); the verdict and the quarantine run
    once per ``WireSpec`` group over its lanes' rows in tree order, as
    JAX's do.  On a clean wire every verdict is True and the decode is
    the one without verdicts, bit for bit."""
    W = gathered.shape[0]
    lanes = {ln.index: ln for ln in plan.leaves}
    pay: dict[int, torch.Tensor] = {}
    for ln in plan.leaves:
        if not ln.dense:
            seg = gathered[:, ln.word_off:ln.word_off + ln.words]
            pay[ln.index] = faults.maybe_corrupt(
                seg.reshape(W * ln.L, ln.spec.row_words), ln.spec,
                ln.index, ln.L)

    ifields: dict[int, torch.Tensor] = {}
    vfields: dict[int, torch.Tensor] = {}
    for b in plan.buckets:
        igroup, vgroup = [], []
        for i in b.leaf_ids:
            spec = lanes[i].spec
            off = spec.header_words
            igroup.append((i, pay[i][:, off:off + spec.index_words], spec.k))
            vgroup.append((i, pay[i][:, off + spec.index_words:
                                     off + spec.index_words
                                     + spec.value_words], spec.k))
        ifields.update(_unpack_sections(igroup, b.index_bits))
        vfields.update(_unpack_sections(
            vgroup, lanes[b.leaf_ids[0]].spec.value_bits))

    out = [None] * len(plan.leaves)
    by_spec: dict = {}
    for ln in plan.leaves:
        if ln.dense:
            continue
        spec, i = ln.spec, ln.index
        ifld, vfld, counts = ifields[i], vfields[i], None
        if spec.ragged:
            # each row at its own header's count: workers may differ
            counts = pay[i][:, 0]
            valid = wire_fmt.field_mask(spec.k, counts, spec.count_period)
            ifld = torch.where(valid, ifld, 0)
            vfld = torch.where(valid, vfld, 0)
        off = spec.header_words
        scale_words = pay[i][:, off - 1:off] if spec.value_bits <= 8 \
            else None
        vals, idx = wire_fmt.fields_to_rows(ifld, vfld, scale_words, counts,
                                            spec)
        if with_verdicts:
            by_spec.setdefault(spec, []).append((ln, vals, idx))
        else:
            out[i] = (vals.reshape(W, ln.L, spec.k),
                      idx.reshape(W, ln.L, spec.k))
    if not with_verdicts:
        return out
    verdicts = [None] * len(plan.leaves)
    for spec, members in by_spec.items():
        cat = [torch.cat(x) if len(members) > 1 else x[0] for x in (
            [pay[ln.index] for ln, _, _ in members],
            [v for _, v, _ in members], [x for _, _, x in members])]
        v = wire_fmt.row_verdict(cat[0], spec, cat[1], cat[2])
        cvals, cidx = wire_fmt.quarantine_rows(cat[1], cat[2], v)
        off = 0
        for ln, _, _ in members:
            rows = W * ln.L
            verdicts[ln.index] = v[off:off + rows].reshape(W, ln.L)
            out[ln.index] = (cvals[off:off + rows].reshape(W, ln.L, spec.k),
                             cidx[off:off + rows].reshape(W, ln.L, spec.k))
            off += rows
    return out, verdicts


def decode_guarded(plan: BucketPlan, gathered: torch.Tensor):
    """``(decoded, verdicts)`` as every transport decodes its gathered
    rows: with the verdicts while ``faults.guards_active()`` (the
    default), else without them and with a verdict of None a lane."""
    if faults.guards_active():
        return decode_buckets(plan, gathered, with_verdicts=True)
    return decode_buckets(plan, gathered), [None] * len(plan.leaves)
