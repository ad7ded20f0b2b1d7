"""Time the PyTorch port's flash-attention decode at chip_smoke.py's gemma3-4b
decode shapes (B 4, 8 q / 4 kv heads of 256, a bf16 cache of 4128 positions,
one query at position 4096; a global layer and a local one of window 1024)
for a range of key-chunk counts, beside the wrapper's own plan and a plain
PyTorch copy of k (the card's streaming rate for the same bytes); and the
wrapper's plan on the same k/v stored head-major ([B, KV, T, hd] memory, each
head's rows contiguous, where the cache interleaves the 4 heads' rows).  Runs on an
NVIDIA GPU only:

    python3 scripts/torch_flash_decode_sweep.py [--seed N]

Prints one JSON line per (layer, chunks) and one for the copy; times are the
median of 10 CUDA-event pairs, each around 16 calls cycling over 4 copies of
k/v (> the L2), with the L2 flushed before each pair and a sleep kernel
ahead of it (as in chip_smoke.py's Timer).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.kernels.flash_attention import kernel as fa_k

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    b, t, kvh, hd, h = 4, 4128, 4, 256, 8
    copies = [tuple(torch.randn(b, t, kvh, hd, device=dev, generator=gen).bfloat16()
                    for _ in range(2)) for _ in range(4)]
    q = torch.randn(b, 1, h, hd, device=dev, generator=gen)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

    def ms(fns) -> float:
        for f in fns:
            f()
        torch.cuda.synchronize()
        times = []
        for _ in range(10):
            flush.zero_()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(20_000_000)
            start.record()
            for f in fns:
                f()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / len(fns))
        return statistics.median(times)

    plan = fa_k.split_plan
    for layer, window in (("decode", 0), ("decode_local", 1024)):
        kw = dict(causal=True, window=window, q_offset=4096, kv_len=4097)
        lo, hi = fa_k.key_range(1, t, **kw)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        calls = [lambda c=c: fa_k.flash_attention(q, *c, **kw) for c in copies] * 4
        own = plan(hi - lo, b * kvh, sms)
        print(json.dumps({"layer": layer, "plan": "wrapper", "kv_layout": "cache",
                          "chunks": own[0], "ms": ms(calls)}), flush=True)
        for chunks in (1, 4, 8, 9, 16, 32, 64, 128):
            fa_k.split_plan = lambda n, blocks, sms, c=chunks: (-(-n // -(-n // c)), -(-n // c))
            try:
                print(json.dumps({"layer": layer, "plan": "fixed", "chunks": chunks,
                                  "ms": ms(calls)}), flush=True)
            finally:
                fa_k.split_plan = plan
        heads = [tuple(x.transpose(1, 2).contiguous().transpose(1, 2) for x in c) for c in copies]
        calls = [lambda c=c: fa_k.flash_attention(q, *c, **kw) for c in heads] * 4
        print(json.dumps({"layer": layer, "plan": "wrapper", "kv_layout": "head_major",
                          "chunks": own[0], "ms": ms(calls)}), flush=True)
        del heads
    copy_ms = ms([lambda c=c: c[0].clone() for c in copies] * 4)
    print(json.dumps({"torch_copy_of_k_ms": copy_ms, "bytes": 2 * copies[0][0].numel() * 2}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
