"""Roofline terms of one rank's step — the port of ``repro.launch.hlo_analysis``.

The reference parses the optimized HLO of a compiled SPMD program
(``parse_hlo``, ``analyze``).  The port compiles nothing: its SPMD program
is written per rank and runs eagerly, so there is no HLO, and those two
functions have no twin here.  In their place :func:`count_step` runs the
rank's step once (on fake tensors, or for real on the card) and counts what
it does, into an :class:`HloStats` with the reference's fields:

  flops            : ``torch.utils.flop_counter.FlopCounterMode`` (2 M N K
                     per product; the flash-attention ops by their own
                     formulas, ``kernels/flash_attention/ops.py``)
  hbm bytes        : every op's tensor inputs read and outputs written once,
                     views, allocations and queries (no tensor out) excluded.  Eager PyTorch fuses
                     nothing, so this is the port's own traffic
  collective bytes : each ``c10d`` collective priced by the reference's
                     wire rule (``hlo_analysis.py:338-347``), its group
                     size read from its process group
  peak bytes       : ``torch.distributed._tools.mem_tracker.MemTracker``,
                     the rank's argument trees held from the start and each
                     flash-attention call's scratch added while it runs;
                     every storage rounded up to the caching allocator's
                     512-byte blocks, on any device

:class:`Roofline` and :func:`model_flops` are the reference's arithmetic,
with the chip's rates a parameter (:class:`ChipSpec`): ``TPU_V5E`` (the
reference's constants, to reproduce its artifacts) and ``H100`` (the
port's own table).
"""

from __future__ import annotations

import dataclasses
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops: float    # the products' peak rate, operations/s
    hbm_bw: float        # bytes/s
    link_bw: float       # bytes/s a link


# the reference's constants (``repro/launch/hlo_analysis.py``: 197 TFLOP/s
# bf16, 819 GB/s HBM, ~50 GB/s a link)
TPU_V5E = ChipSpec("tpu-v5e", 197e12, 819e9, 50e9)
# NVIDIA H100 SXM5 at its 700 W limit (NVIDIA's H100 Tensor Core GPU data
# sheet): 67 TFLOP/s float32 outside the tensor cores, the products' own
# peak (the port's products are float32 and TF32 stays off), 3.35 TB/s of
# HBM3, and NVLink 4's 900 GB/s a card, 450 GB/s each way
H100 = ChipSpec("h100-sxm5", 67e12, 3.35e12, 450e9)


@dataclasses.dataclass
class HloStats:
    flops: float
    hbm_bytes: float
    collective_wire_bytes: float
    collective_counts: dict
    collective_by_kind: dict
    peak_bytes: float = 0.0
    seconds: float = 0.0
    hbm_by_op: dict = dataclasses.field(default_factory=dict)   # the 8 largest
    peak_by_kind: dict = dataclasses.field(default_factory=dict)  # at the peak

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


# the c10d ops ``core.backends.direct`` lowers to -> the reference's kinds
_COLLECTIVES = {
    "allreduce_": "all-reduce",
    "_allgather_base_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_base_": "all-to-all",
    "broadcast_": "collective-permute",
    "send": "collective-permute",
}
_ALLOCS = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided"}


def _tensors(x) -> list[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def wire_bytes(kind: str, nbytes: float, g: int) -> float:
    """The reference's wire rule for one collective over a group of ``g``
    whose result holds ``nbytes``."""
    if kind == "all-gather":
        return nbytes * (g - 1) / g
    if kind == "reduce-scatter":
        return nbytes * (g - 1)
    if kind == "all-reduce":
        return 2 * nbytes * (g - 1) / g
    if kind == "all-to-all":
        return nbytes * (g - 1) / g
    return nbytes


def _group_size(arg) -> int:
    """The size of a process group passed to a ``c10d`` op (a script
    object), else 0."""
    if not isinstance(arg, torch.ScriptObject):
        return 0
    try:
        return int(torch.distributed.ProcessGroup.unbox(arg).size())
    except RuntimeError:  # another script object (a reduce op)
        return 0


class _Traffic(TorchDispatchMode):
    """The HBM bytes and collectives of every op that reaches dispatch."""

    def __init__(self):
        super().__init__()
        self.hbm = 0.0
        self.wire = 0.0
        self.counts: dict[str, int] = {}
        self.by_kind: dict[str, float] = {}
        self.by_op: dict[str, float] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns = func.namespace
        name = func.overloadpacket.__name__
        if ns == "c10d":
            kind = _COLLECTIVES.get(name)
            if kind is not None:
                self._collective(kind, args)
            return out
        outs = _tensors(out)
        if func.is_view or name in _ALLOCS or not outs:  # views, allocations, queries
            return out
        b = _nbytes(_tensors(args)) + _nbytes(_tensors(kwargs)) + _nbytes(outs)
        self.hbm += b
        key = f"{ns}.{name}"
        self.by_op[key] = self.by_op.get(key, 0.0) + b
        return out

    def _collective(self, kind: str, args) -> None:
        g = next(n for n in map(_group_size, args) if n)
        # the result: the output tensor (the first argument) of every kind
        nbytes = _nbytes(_tensors(args[0]))
        if g <= 1:
            return
        w = wire_bytes(kind, nbytes, g)
        self.counts[kind] = self.counts.get(kind, 0) + 1
        self.by_kind[kind] = self.by_kind.get(kind, 0.0) + w
        self.wire += w


def count_step(fn, *, held=()) -> tuple[object, HloStats]:
    """Run ``fn()`` once under the counters; returns (its result, the
    counts).  ``held``: trees of tensors that exist before the step (the
    rank's arguments), counted in the peak from the start."""
    from torch.distributed._tools import mem_tracker
    from torch.distributed._tools.mem_tracker import MemTracker, _MemRefType, _ModState
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels.flash_attention import ops as fa_ops

    class _Peak(MemTracker):
        """MemTracker plus each flash-attention call's scratch, which its
        fake implementation allocates where no mode sees it."""

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            res = super().__torch_dispatch__(func, types, args, kwargs)
            pending = fa_ops.fake_scratch
            if pending:
                n = sum(pending)
                pending.clear()
                dev = next((t.device for t in _tensors(args)), None)
                scratch = torch.empty(n, dtype=torch.uint8, device=dev)
                self._track(_MemRefType.TEMP, scratch)
                self._update_peak_stats(_ModState.PEAK_BW if self._mod_tracker.is_bw
                                        else _ModState.PEAK_FW)
                del scratch
            return res

    # every storage as the card's caching allocator holds it (its bytes
    # rounded up to 512), whatever the tensors' device: MemTracker rounds so
    # for CUDA tensors only, and a trace on CPU fakes estimates the card
    winfo = mem_tracker._WeakRefInfo
    as_tracked = winfo._calculate_mem_consumed
    winfo._calculate_mem_consumed = lambda self: -(-self.size * self.element_size // 512) * 512
    traffic = _Traffic()
    flops = FlopCounterMode(display=False)
    peak = _Peak()
    fa_ops.fake_scratch = []
    t0 = time.perf_counter()
    try:
        args = _tensors(list(held))
        if args:
            peak.track_external(*args)
        with peak, flops, traffic:
            out = fn()
    finally:
        fa_ops.fake_scratch = None
        winfo._calculate_mem_consumed = as_tracked
    seconds = time.perf_counter() - t0
    snap = max(peak.get_tracker_snapshot("peak").values(), key=lambda v: v["Total"], default={})
    peak_bytes = snap.get("Total", 0)
    # MemTracker's kinds: "Activation" (made in a forward), "Temp" (in a
    # backward), "Other" (the arguments held)
    by_kind = {getattr(k, "value", k): int(v) for k, v in snap.items() if v and k != "Total"}
    return out, HloStats(float(flops.get_total_flops()), traffic.hbm, traffic.wire,
                         dict(traffic.counts), {k: int(v) for k, v in traffic.by_kind.items()},
                         float(peak_bytes), seconds,
                         dict(sorted(((k, int(v)) for k, v in traffic.by_op.items()),
                                     key=lambda kv: -kv[1])[:8]), by_kind)


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    hbm_bytes_per_device: float
    collective_wire_bytes: float
    model_flops_total: float
    chips: int
    chip: ChipSpec = TPU_V5E

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / self.chip.peak_flops

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_per_device / self.chip.hbm_bw

    @property
    def collective_s(self) -> float:
        return self.collective_wire_bytes / self.chip.link_bw

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_compute_ratio(self) -> float:
        """MODEL_FLOPS / (flops x chips): fraction of the counted compute
        that is algorithmically required (catches remat/redundancy)."""
        hlo_total = self.flops_per_device * self.chips
        return self.model_flops_total / max(hlo_total, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """Model-FLOPs utilization at the modeled bound (static-MFU bound):
        MODEL_FLOPS / (chips x peak x max-term-seconds)."""
        t = self.bound_s
        return self.model_flops_total / (self.chips * self.chip.peak_flops * t) if t else 0.0

    def as_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "hbm_bytes_per_device": self.hbm_bytes_per_device,
            "collective_wire_bytes": self.collective_wire_bytes,
            "model_flops_total": self.model_flops_total,
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "useful_compute_ratio": self.useful_compute_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops(cfg, cell) -> float:
    """6*N*D (train) / 2*N*D (inference), N = active params, D = tokens."""
    n = cfg.active_param_count()
    if cell.kind == "train":
        d = cell.global_batch * cell.seq_len
        return 6.0 * n * d
    if cell.kind == "prefill":
        d = cell.global_batch * cell.seq_len
        return 2.0 * n * d
    d = cell.global_batch * 1
    return 2.0 * n * d
