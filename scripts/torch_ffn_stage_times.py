#!/usr/bin/env python3
"""Per-stage device times of the bf16 kernels of tpudepth_torch on the
``wgmma`` core (``mlp_infer``, ``mlp_train_fwd``, ``mlp_train_bwd``,
``block_epilogue_infer``) on one NVIDIA GPU, with the split of each call
into its CUDA kernels.

    python3 scripts/torch_ffn_stage_times.py [--check] [--tag NAME]
        [--json PATH]

Run it from the root of a checkout: it imports the ``tpudepth_torch`` found
there, so the same script times two trees in one call (``cd`` into each).
At the four SAM / NewCRF stage shapes of a 480x640 batch-8 bf16 step,
(M, C) = (2400, 1024), (9600, 512), (38400, 256), (153600, 128) with
H = 4C, it prints per kernel and stage:

- ``[stage time]``: one call's device time from CUDA graph replays (warm
  L2, as ``chip_smoke.py`` times), the same products in cuBLAS (bf16, the
  weights cast beforehand) and the bound (bytes once at 3.35 TB/s or
  operations at 989 TFLOP/s, whichever is larger; ``chip_smoke.py``'s
  formulas);
- ``[stage split]``: a ``torch.profiler`` trace of 3 calls, the device time
  per call of each CUDA kernel the call launches, by name;
- with ``--check``: the kernel against its plain version at the module's
  tolerance (``flip_atol`` added for the backward), and a rerun bit-equal.

The card's name and power limit come first; ``--json`` writes a summary
(every number above) to PATH. It needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
STAGES = [("crf3", 2400, 1024), ("crf2", 9600, 512), ("crf1", 38400, 256),
          ("crf0", 153600, 128)]


def time_ms(fn, per_graph: int = 4, replays: int = 10) -> float:
    """Median device time of one call over CUDA graph replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_graph)
    return statistics.median(times)


def split_ms(fn, calls: int = 3):
    """Device ms per call of each CUDA kernel ``fn`` launches, by name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = []
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0):
            out.append((e.key, e.self_device_time_total / calls / 1e3,
                        e.count // calls))
    return sorted(out, key=lambda r: -r[1])


def bound(nbytes, flops):
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    return max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def close(got, want, tol, extra=None):
    frac, rtol = tol
    g, w = got.float(), want.float()
    lim = frac * float(w.abs().max()) + rtol * w.abs()
    if extra is not None:
        lim = lim + extra
    return bool(((g - w).abs() <= lim).all()), float((g - w).abs().max())


def inputs(seed, m, c, dev):
    """Seeded rows, weights [in, out] of std 1/sqrt(fan_in), vectors (the
    FFN's b2 drawn last, so the rest are the inputs of earlier runs)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def n(*shape, s=1.0, mean=0.0, dt=torch.float32):
        return (mean + s * torch.randn(*shape, generator=g, device=dev)).to(dt)

    h, bf = 4 * c, torch.bfloat16
    ffn = dict(x=n(m, c, dt=bf), w1=n(c, h, s=c ** -0.5), b1=n(h, s=0.1),
               w2=n(h, c, s=h ** -0.5), gy=n(m, c, dt=bf))
    tail = dict(o=n(m, c, dt=bf), x=n(m, c, dt=bf),
                wproj=n(c, c, s=c ** -0.5), bproj=n(c, s=0.1),
                lns=n(c, s=0.2, mean=1.0), lnb=n(c, s=0.1),
                w1=n(c, h, s=c ** -0.5), b1=n(h, s=0.1),
                w2=n(h, c, s=h ** -0.5), b2=n(c, s=0.1))
    ffn["b2"] = n(c, s=0.1)
    return ffn, tail


def check_call(name, kern, ffn, tail, x, gy):
    """(the kernel's errors against its plain version, each within the
    module's tolerance?, a rerun bit-equal?)"""
    from tpudepth_torch.ops.kernels import epilogue_infer as ei
    from tpudepth_torch.ops.kernels import mlp_infer as mi
    from tpudepth_torch.ops.kernels import mlp_train as mt

    got, again = kern(), kern()
    args = (x, ffn["w1"], ffn["b1"], ffn["w2"], ffn["b2"])
    if name == "mlp_train_bwd":
        want = mt.mlp_train_bwd_reference(x, gy, *args[1:4])
        flips = mt.flip_atol(x, gy, *args[1:4])
        out_tol, w_tol = mt.tolerance(torch.bfloat16)
        oks = [close(got[0], want[0], out_tol, flips[0])]
        oks += [close(a, b, w_tol, f) for a, b, f in
                zip(got[1:], want[1:], flips[1:])]
        return oks, all(torch.equal(a, b) for a, b in zip(got, again))
    if name == "mlp_infer":
        want, tol = mi.mlp_infer_reference(*args), mi.tolerance(torch.bfloat16)
    elif name == "mlp_train_fwd":
        want = mt.mlp_train_fwd_reference(*args)
        tol = mt.tolerance(torch.bfloat16)[0]
    else:
        want = ei.block_epilogue_infer_reference(**tail)
        tol = ei.tolerance(torch.bfloat16)
    return [close(got, want, tol)], torch.equal(got, again)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--json", help="write the summary to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_ffn_stage_times: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    from tpudepth_torch.ops.kernels import epilogue_infer as ei
    from tpudepth_torch.ops.kernels import mlp_infer as mi
    from tpudepth_torch.ops.kernels import mlp_train as mt

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout else "not read"
    print(f"[{args.tag}] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    dev = torch.device("cuda")
    result = {"card": card, "tag": args.tag, "stages": []}
    ok_all = True
    for i, (stage, m, c) in enumerate(STAGES):
        h = 4 * c
        ffn, tail = inputs(1000 + i, m, c, dev)
        x, gy = ffn["x"], ffn["gy"]
        w1b, w2b = ffn["w1"].bfloat16(), ffn["w2"].bfloat16()
        o = tail["o"]
        wpb = tail["wproj"].bfloat16()
        hbuf = torch.empty(m, h, dtype=torch.bfloat16, device=dev)

        args_ffn = (x, ffn["w1"], ffn["b1"], ffn["w2"], ffn["b2"])
        w = 2 * c * h
        cases = {
            "mlp_infer": (
                lambda: mi.mlp_infer(*args_ffn),
                lambda: (x @ w1b, hbuf @ w2b),
                bound(2 * m * c * 2 + w * 4 + (c + h) * 4, 4 * m * c * h)),
            "mlp_train_fwd": (
                lambda: mt.mlp_train_fwd(*args_ffn),
                lambda: (x @ w1b, hbuf @ w2b),
                bound(2 * m * c * 2 + w * 2 + (h + c) * 4, 4 * m * c * h)),
            "mlp_train_bwd": (
                lambda: mt.mlp_train_bwd(x, gy, ffn["w1"], ffn["b1"],
                                         ffn["w2"]),
                lambda: (x @ w1b, gy @ w2b.t(), hbuf @ w1b.t(),
                         x.t() @ hbuf, hbuf.t() @ gy),
                bound(3 * m * c * 2 + w * 2 + w * 4 + (h + c) * 4,
                      10 * m * c * h)),
            "block_epilogue_infer": (
                lambda: ei.block_epilogue_infer(**tail),
                lambda: (o @ wpb, x @ w1b, hbuf @ w2b),
                bound(3 * m * c * 2 + (c * c + 2 * c * h) * 4
                      + (4 * c + h) * 4, 2 * m * c * (c + 2 * h))),
        }
        for name, (kern, lib, (bnd, by)) in cases.items():
            row = {"kernel": name, "stage": stage, "M": m, "C": c}
            if args.check:
                oks, same = check_call(name, kern, ffn, tail, x, gy)
                torch.cuda.synchronize()
                ok = all(o_ for o_, _ in oks) and same
                ok_all &= ok
                row.update(check=ok, max_abs_err=[e for _, e in oks],
                           rerun_equal=same)
                print(f"[stage check] {name:<20} {stage} (M {m}, C {c}): "
                      f"{'ok' if ok else 'FAILED'}, max abs err "
                      f"{[f'{e:.3g}' for _, e in oks]}, rerun "
                      f"{'bit-equal' if same else 'DIFFERS'}", flush=True)
            ms, lib_ms = time_ms(kern), time_ms(lib)
            row.update(ms=ms, library_ms=lib_ms, bound_ms=bnd, bound_by=by)
            print(f"[stage time] {name:<20} {stage} B8 bf16 (M {m}, C {c}): "
                  f"kernel {ms:.4f} ms, cuBLAS {lib_ms:.4f} ms, bound "
                  f"{bnd:.4f} ms ({by}; {100 * bnd / ms:.1f}% of bound)",
                  flush=True)
            row["split"] = split_ms(kern)
            for key, k_ms, count in row["split"]:
                print(f"[stage split] {name:<20} {stage}: {k_ms:8.4f} ms x"
                      f"{count} {key[:100]}", flush=True)
            result["stages"].append(row)
        del ffn, tail, hbuf
        torch.cuda.empty_cache()
    for name in dict.fromkeys(r["kernel"] for r in result["stages"]):
        rows = [r for r in result["stages"] if r["kernel"] == name]
        print(f"[stage total] {name:<20} 4 stages: kernel "
              f"{sum(r['ms'] for r in rows):.4f} ms, cuBLAS "
              f"{sum(r['library_ms'] for r in rows):.4f} ms, bound "
              f"{sum(r['bound_ms'] for r in rows):.4f} ms", flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
