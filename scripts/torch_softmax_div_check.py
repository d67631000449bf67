#!/usr/bin/env python3
"""Holds ``wattn::div_rn`` of ``tpudepth_torch/csrc/window_attn.cuh`` (the
bf16 forward attention's softmax division: one reciprocal a row, the
quotient corrected by its remainder) bit for bit against the IEEE division
``__fdiv_rn(x, s)`` on one NVIDIA GPU, over the inputs a softmax gives it
(0 <= x <= 1 <= s <= 64):

- zero, every denormal x and every x of the binades 2^-126 and 2^-107, over
  16 sums (1, 64, powers of two and their neighbours, 49, random);
- 2^27 random x of the normal binades below 1 (log-uniform, random
  mantissas), 2^27 random denormals and 2^27 uniform in [0, 1], each over a
  random sum in [1, 64].

    python3 scripts/torch_softmax_div_check.py

It compiles a small CUDA source that includes the header (nvcc, as the
package's ``_build`` does), prints the card's name and power limit, the
pairs checked and the unequal ones per class, and exits 1 if any differ.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tpudepth_torch.ops.kernels import _build  # noqa: E402

SOURCE = r"""
#include "%s"

__global__ void check(const float* x, const float* s, long long n,
                      unsigned long long* bad, long long* first) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float got = wattn::div_rn(x[i], s[i], __frcp_rn(s[i]));
    const float want = __fdiv_rn(x[i], s[i]);
    if (__float_as_uint(got) != __float_as_uint(want)) {
      atomicAdd(bad, 1ull);
      atomicMin(first, i);
    }
  }
}

extern "C" int div_check(const float* x, const float* s, long long n,
                         unsigned long long* bad, long long* first) {
  check<<<1056, 256>>>(x, s, n, bad, first);
  return (int)cudaGetLastError();
}
"""


def build() -> ctypes.CDLL:
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="div_check_", dir=_build.BUILD_DIR)
    src = os.path.join(tmp, "div_check.cu")
    with open(src, "w") as f:
        f.write(SOURCE % (_build.SRC_DIR / "window_attn.cuh"))
    lib = os.path.join(tmp, "libdiv_check.so")
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
                   check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(lib)
    dll.div_check.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [
        ctypes.c_void_p] * 2
    dll.div_check.restype = ctypes.c_int
    return dll


def sums(dev):
    one, two = torch.tensor([1.0, 2.0])
    edges = [1.0, 64.0, 2.0, 4.0, 32.0, 49.0,
             float(torch.nextafter(one, two)),
             float(torch.nextafter(two, one)),
             float(torch.nextafter(two, two + 1)),
             float(torch.nextafter(torch.tensor(64.0), one)),
             3.0, 7.0, 48.99999]
    g = torch.Generator().manual_seed(1)
    edges += (1 + 63 * torch.rand(3, generator=g)).tolist()
    return torch.tensor(edges, dtype=torch.float32, device=dev)


def run(dll, x, s):
    bad = torch.zeros(1, dtype=torch.int64, device=x.device)
    first = torch.full((1,), 2 ** 62, dtype=torch.int64, device=x.device)
    rc = dll.div_check(x.data_ptr(), s.data_ptr(), x.numel(), bad.data_ptr(),
                       first.data_ptr())
    if rc:
        raise RuntimeError(f"div_check launch failed: CUDA error {rc}")
    torch.cuda.synchronize()
    n_bad = int(bad)
    where = int(first) if n_bad else None
    return n_bad, (None if where is None else
                   (float(x[where]), float(s[where])))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_softmax_div_check: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dll = build()
    classes = []
    # every x with the bit patterns 0 .. 2^23 - 1 (zero and the denormals)
    # and of the binades 2^-126 and 2^-107
    bits = torch.arange(0, 1 << 23, dtype=torch.int32, device=dev)
    for s_val in sums(dev):
        for lo in (0, 1 << 23, 20 << 23):   # 0, 2^-126, 2^-107
            x = (bits + lo).view(torch.float32)
            classes.append((f"x bits {lo:#x}.. s {float(s_val):.7g}", x,
                            s_val.expand_as(x).contiguous()))
    g = torch.Generator(device=dev).manual_seed(0)
    n = 1 << 27
    e = torch.randint(1, 127, (n,), generator=g, device=dev, dtype=torch.int32)
    m = torch.randint(0, 1 << 23, (n,), generator=g, device=dev,
                      dtype=torch.int32)
    x_log = ((e << 23) | m).view(torch.float32)       # 2^-126 .. 1, every binade
    x_den = (m >> torch.randint(0, 23, (n,), generator=g, device=dev,
                                dtype=torch.int32)).view(torch.float32)
    s_rand = 1 + 63 * torch.rand(n, generator=g, device=dev)
    classes += [("x log-uniform, s random", x_log, s_rand),
                ("x denormal, s random", x_den, s_rand),
                ("x uniform [0, 1], s random",
                 torch.rand(n, generator=g, device=dev), s_rand)]
    total = total_bad = 0
    for name, x, s in classes:
        n_bad, first = run(dll, x, s)
        total += x.numel()
        total_bad += n_bad
        if n_bad or "random" in name:
            print(f"[div check] {name}: {x.numel()} pairs, {n_bad} unequal"
                  + (f" (first x {first[0]!r}, s {first[1]!r})" if n_bad
                     else ""), flush=True)
    print(f"[div check] {total} pairs, {total_bad} unequal to __fdiv_rn",
          flush=True)
    return 1 if total_bad else 0


if __name__ == "__main__":
    sys.exit(main())
