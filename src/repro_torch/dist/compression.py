"""Wire compression: int8 gradient compression (EF-SGD) and the columnar
shuffle codec — the port of ``repro.dist.compression``, on tensors.

Gradients.  The data-parallel gradient all-reduce is bandwidth-bound, so
the dp-axis reduction trades precision for bytes: each shard
block-quantizes its gradient to int8 with one float32 scale per ``_BLOCK``
values, keeps the quantization residual locally, and adds it back into the
next step's gradient (error feedback).  ``compressed_pmean`` runs on every
rank of a mesh axis (``core.backends.direct``): each rank all-gathers only
the int8 payload and the scales, then dequantizes and averages the same
way, so all ranks hold the same mean without a trusted root.
``quantize_slots`` / ``dequantize_slots`` do the same to an alltoallv send
buffer (the SPMD shuffle's ``compress=True``).  The int8 values and scales
are the reference's for the same float32 input.  The reference runs these
under ``jit``, where XLA turns its ``max / 127.0`` into a multiply by
float32(1/127), which is one ulp off the division for ~5% of the blocks; so
these scales multiply by it too (``_INV127``), while the shuffle codec
below, whose reference is numpy, divides.

Shuffle codec.  The alltoallv shuffle in ``dataframe/ops_dist.py`` is the
communication-bound exchange (paper §IV: the distributed join's scaling
curve is set by the shuffle, not the local join).  Its wire format is
per-column, with eligibility decided by *role*:

- **Key columns** must round-trip bit-exact — ``hash(key) % P`` routing and
  join equality depend on the decoded value — so integer keys get an exact
  encoding: *dictionary* (codes into a unique-value table) or *narrow*
  (offsets from the column min in the smallest unsigned width that spans
  the range), whichever is smaller, with raw passthrough as the floor.
  Non-integer keys are never quantized.
- **Value columns** may trade precision for bytes: floats ship as block-int8
  with one float32 scale per ``_BLOCK`` values (per-block max error
  ``blockmax/254``); integer values take the exact key treatment so
  aggregates over them stay exact.

Every part of an encoded column stays on the device of the column it
encodes.  The choice of encoding reads three numbers on the host per
integer column (its min, its max and its count of unique values), as the
reference does; on the card each is a synchronization.  Kinds, wire bytes
and decoded values are the reference's for the same column:

- the narrow offsets are computed in ``int64`` (for ``int64`` columns as
  wrapping two's-complement subtraction) and cast to the unsigned width
  last, since torch's ``uint16``/``uint32``/``uint64`` support few
  operations beyond casts on the card;
- ``torch.unique(sorted=True, return_inverse=True)`` gives ``np.unique``'s
  table and codes;
- ``torch.round`` rounds half to even as ``np.round`` does, and the scales
  divide (by a tensor: a scalar divisor is a reciprocal multiply on the
  card) and clamp (``1e-30``) in float32 as the reference's do.

``EncodedColumn.wire_nbytes`` is what the codec ships; ``raw_nbytes`` is
what the uncompressed path would have shipped (it stacks every column into
one float64 row-matrix), so ``raw_nbytes / wire_nbytes`` is the
per-column compression ratio.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.core.backends import direct
from repro_torch.dist import treepath

_BLOCK = 128  # values per quantization block (one float32 scale each)

# The raw sim shuffle stacks every column into a float64 row-matrix, so the
# uncompressed wire cost is 8 bytes per value regardless of column dtype.
_RAW_ITEMSIZE = 8

# (unsigned width, its largest value), narrowest first
_NARROW_WIDTHS = (
    (torch.uint8, 2**8 - 1),
    (torch.uint16, 2**16 - 1),
    (torch.uint32, 2**32 - 1),
    (torch.uint64, 2**64 - 1),
)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _is_integer(dtype: torch.dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex or dtype == torch.bool)


@dataclasses.dataclass
class EncodedColumn:
    """One column of one shuffle block, ready for the wire.

    ``kind`` is the chosen encoding:

    - ``"dict"``   : ``parts = {codes, uniques}`` — exact (integer columns)
    - ``"narrow"`` : ``parts = {offsets}`` + ``origin`` — exact (integer)
    - ``"raw"``    : ``parts = {values}`` — exact passthrough (any dtype)
    - ``"int8"``   : ``parts = {q, scales}`` — lossy block-int8 (float values)
    """

    kind: str
    dtype: torch.dtype       # dtype the decoder must restore
    count: int               # valid rows in this block
    parts: dict[str, torch.Tensor]
    origin: int = 0          # narrow encoding: column min (decoded offset base)

    @property
    def wire_nbytes(self) -> int:
        meta = 8 if self.kind == "narrow" else 0  # origin travels as int64
        return int(sum(_nbytes(a) for a in self.parts.values())) + meta

    @property
    def raw_nbytes(self) -> int:
        return self.count * _RAW_ITEMSIZE


def _narrow_dtype(spread: int) -> torch.dtype | None:
    for dtype, top in _NARROW_WIDTHS:
        if spread <= top:
            return dtype
    return None


def _encode_int_exact(arr: torch.Tensor) -> EncodedColumn:
    """Smallest of dictionary / narrow / raw; all three round-trip bit-exact."""
    n = arr.shape[0]
    if n == 0:
        return EncodedColumn("raw", arr.dtype, 0, {"values": arr})
    lo, hi = int(arr.min()), int(arr.max())
    candidates: list[EncodedColumn] = [
        EncodedColumn("raw", arr.dtype, n, {"values": arr})
    ]
    ndt = _narrow_dtype(hi - lo)
    if ndt is not None and ndt.itemsize < arr.element_size():
        # 0 <= value - lo <= spread < 2^32 here: in int64 the difference is
        # exact for every narrower column, and for an int64 column the
        # wrapping subtraction still lands on the true offset
        offsets = (arr.to(torch.int64) - lo).to(ndt)
        candidates.append(
            EncodedColumn("narrow", arr.dtype, n, {"offsets": offsets}, origin=lo)
        )
    uniques, codes = torch.unique(arr, sorted=True, return_inverse=True)
    cdt = _narrow_dtype(max(uniques.shape[0] - 1, 0))
    if cdt is not None:
        candidates.append(
            EncodedColumn(
                "dict", arr.dtype, n,
                {"codes": codes.to(cdt), "uniques": uniques},
            )
        )
    return min(candidates, key=lambda e: e.wire_nbytes)


_INV127 = 1.0 / 127.0  # rounded to float32 where it multiplies a float32 tensor


def _int8(blocks: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """round(blocks / scale) clipped to [-127, 127] (half to even, as
    ``jnp.round``), with the reference's 1e-30 floor on the scale."""
    q = torch.round(blocks / torch.clamp(scale[..., None], min=1e-30))
    return torch.clamp(q, -127, 127).to(torch.int8)


def _quantize_blocks(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Block-wise symmetric int8 quantization of ``x`` (its size a multiple
    of ``_BLOCK``): ``(q, scale)``, ``q`` int8 of ``x``'s shape and one
    float32 scale per block of ``_BLOCK`` consecutive values (flattened
    order), blockmax x float32(1/127) as the reference's jitted quantizer.
    Per-block max error is ``scale / 2``."""
    flat = x.to(torch.float32).reshape(-1, _BLOCK)
    scale = flat.abs().amax(dim=-1) * flat.new_tensor(_INV127)
    return _int8(flat, scale).reshape(x.shape), scale


def _dequantize_blocks(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    flat = q.to(torch.float32).reshape(-1, _BLOCK) * scale[:, None]
    return flat.reshape(q.shape)


def _pad_to_block(flat: torch.Tensor) -> torch.Tensor:
    pad = (-flat.shape[0]) % _BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat


def compressed_pmean(g: torch.Tensor, axis: str, err: torch.Tensor | None = None, *,
                     mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 mean over mesh ``axis``, called by every rank of
    the axis with its own ``g``.

    ``err`` is this rank's residual from the previous step (None on the
    first).  Returns ``(mean, new_err)``: ``mean`` is the same on every rank
    (each dequantizes every rank's payload in rank order); ``new_err`` stays
    local and is bounded by one quantization step of the compensated
    gradient."""
    shape = g.shape
    compensated = g if err is None else g + err
    flat = _pad_to_block(compensated.to(torch.float32).reshape(-1))
    q, scale = _quantize_blocks(flat)
    new_err = flat - _dequantize_blocks(q, scale)  # the residual never crosses the wire
    # wire payload: int8 values + one float32 scale per block
    q_all = direct.allgather(q[None], axis, dim=0, mesh=mesh)        # [P, n]
    s_all = direct.allgather(scale[None], axis, dim=0, mesh=mesh)    # [P, n / _BLOCK]
    world = q_all.shape[0]
    deq = q_all.to(torch.float32).reshape(world, -1, _BLOCK) * s_all[:, :, None]
    mean = deq.mean(0).reshape(-1)
    n = math.prod(shape)
    return mean[:n].reshape(shape), new_err[:n].reshape(shape)


def wire_bytes_saved(tree: Any) -> dict:
    """Bytes on the wire for one gradient exchange of ``tree``: int8 + scales
    against bf16 (the ratio the train loop logs)."""
    sizes = [leaf.numel() for leaf in treepath.leaves(tree)]
    n = int(sum(sizes))
    bf16_bytes = 2 * n
    compressed = int(sum(s + 4 * (-(-s // _BLOCK)) for s in sizes))
    return {
        "elements": n,
        "bf16_bytes": bf16_bytes,
        "compressed_bytes": compressed,
        "ratio_vs_bf16": bf16_bytes / max(compressed, 1),
        "block": _BLOCK,
    }


def quantize_slots(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Block-int8 quantize an alltoallv send buffer ``[P, cap, ...]``: each
    destination slot's rows flattened, zero-padded to a block multiple and
    quantized in ``_BLOCK`` blocks.  Returns ``(q [P, n], scales [P,
    n / _BLOCK])``, the two fixed-shape payloads that replace the float
    buffer on the wire."""
    p = x.shape[0]
    flat = x.to(torch.float32).reshape(p, -1)
    pad = (-flat.shape[1]) % _BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros((p, pad))], dim=1)
    blocks = flat.reshape(p, -1, _BLOCK)
    scale = blocks.abs().amax(dim=-1) * blocks.new_tensor(_INV127)
    return _int8(blocks, scale).reshape(p, -1), scale


def dequantize_slots(q: torch.Tensor, scale: torch.Tensor, shape: tuple[int, ...],
                     dtype: torch.dtype) -> torch.Tensor:
    """Invert :func:`quantize_slots` back to ``shape`` (trims the pad)."""
    p = q.shape[0]
    deq = q.to(torch.float32).reshape(p, -1, _BLOCK) * scale[..., None]
    n = math.prod(shape[1:])
    return deq.reshape(p, -1)[:, :n].reshape(shape).to(dtype)


def encode_column(arr: torch.Tensor, *, exact: bool) -> EncodedColumn:
    """Encode one 1-D column for the shuffle wire.

    ``exact=True`` (key columns, and integer value columns) picks a bit-exact
    encoding; ``exact=False`` on a float column ships block-int8 + scales.
    """
    arr = arr.contiguous()
    if arr.dim() != 1:
        raise ValueError(f"codec expects 1-D columns, got shape {tuple(arr.shape)}")
    if _is_integer(arr.dtype):
        return _encode_int_exact(arr)
    if exact or not arr.dtype.is_floating_point:
        return EncodedColumn("raw", arr.dtype, arr.shape[0], {"values": arr})
    blocks = _pad_to_block(arr.to(torch.float32)).reshape(-1, _BLOCK)
    # numpy's division: by a tensor, not a Python scalar (on the card a
    # scalar divisor becomes a multiply by its reciprocal)
    scales = blocks.abs().amax(dim=-1) / blocks.new_tensor(127.0)
    q = _int8(blocks, scales)
    # ship only the valid int8 values; decode re-pads to the block multiple
    return EncodedColumn(
        "int8", arr.dtype, arr.shape[0],
        {"q": q.reshape(-1)[: arr.shape[0]], "scales": scales},
    )


def decode_column(enc: EncodedColumn) -> torch.Tensor:
    if enc.kind == "raw":
        return enc.parts["values"].to(enc.dtype)
    if enc.kind == "narrow":
        return (enc.parts["offsets"].to(torch.int64) + enc.origin).to(enc.dtype)
    if enc.kind == "dict":
        return enc.parts["uniques"][enc.parts["codes"].to(torch.int64)].to(enc.dtype)
    if enc.kind == "int8":
        q = _pad_to_block(enc.parts["q"])
        return _dequantize_blocks(q, enc.parts["scales"])[: enc.count].to(enc.dtype)
    raise ValueError(f"unknown encoding kind {enc.kind!r}")


@dataclasses.dataclass
class EncodedBlock:
    """One (src, dst) cell of a compressed alltoallv: all columns of a block."""

    columns: dict[str, EncodedColumn]
    count: int

    @property
    def wire_nbytes(self) -> int:
        return sum(c.wire_nbytes for c in self.columns.values())

    @property
    def raw_nbytes(self) -> int:
        return sum(c.raw_nbytes for c in self.columns.values())


def encode_block(
    columns: dict[str, torch.Tensor], key_cols: set[str] | frozenset[str]
) -> EncodedBlock:
    """Encode a dict of equal-length columns; ``key_cols`` are exact-only."""
    counts = {a.shape[0] for a in columns.values()}
    if len(counts) > 1:
        raise ValueError(f"ragged block: {counts}")
    n = counts.pop() if counts else 0
    return EncodedBlock(
        {
            name: encode_column(arr, exact=name in key_cols)
            for name, arr in columns.items()
        },
        n,
    )


def decode_block(block: EncodedBlock) -> dict[str, torch.Tensor]:
    return {name: decode_column(enc) for name, enc in block.columns.items()}
