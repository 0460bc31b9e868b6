#!/usr/bin/env python
"""Registers, spills and times of the pairwise register kernel at candidate
tiers, on the card.

    python3 scripts/pairwise_cap_probe.py

``reg_pairwise`` (``src/repro_torch/kernels/csrc/pairwise_dist.cu``) keeps
N(N-1)/2 pair sums and N column values a thread in registers, so its N cap
and its threads a CTA are set by what ptxas can hold without spilling.  This
script compiles the kernel at every candidate tier (N cap 10-16; 256, 384 or
512 threads; 1, 2 or 4 columns a load; f32 and bf16 W), each tier list its
own library built by its own ``nvcc`` (all started together), and prints
each kernel's registers and local memory (spills) from
``cudaFuncGetAttributes``.  Then, in f32, it times every tier that does not
spill at N = 10 and at N = its cap, two columns a load at D = 582,026 and
four at D = 8,000,000, as ``chip_smoke.py`` times a kernel (CUDA events, L2
flushed, median of 50; and with a clean L2), each output held to the plain
version at 5e-6 of its max.  Tiers compiled for exactly N = 10 (with and
without the next step's loads issued early) are timed beside them.  Exits 1
without a CUDA device.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
import chip_smoke  # noqa: E402  (its helpers)

#: (W dtype, N cap, exact, columns a step, pipelined, threads, V)
GENERAL = [(dt, nc, False, 1, False, t, v)
           for dt in ("float", "bf16") for t in (256, 384, 512)
           for nc in (10, 11, 12, 13, 14, 16) for v in (1, 2, 4)]
PIPED = [("float", nc, False, 1, True, t, v) for t in (384, 512)
         for nc in (10, 12, 13) for v in (2, 4)]
EXACT = [("float", 10, True, 2 if pipe else 1, pipe, t, v)
         for pipe in (False, True) for t in (384, 512) for v in (2, 4)]
VARIANTS = GENERAL + PIPED + EXACT
MAIN_D = 582_026

_ONE = """template <typename T, class TIER, int V>
int probe_one(int op, const void* w, float* partials, unsigned* ticket,
              float* out, int n, long long d, int grid, void* stream,
              int* res) {
  const auto kernel = reg_pairwise<T, TIER, V>;
  if (op == 0) {
    cudaFuncAttributes attr{};
    const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    res[0] = attr.numRegs;
    res[1] = static_cast<int>(attr.localSizeBytes);
    return err;
  }
  int device = 0;
  cudaGetDevice(&device);
  if (op == 1) return sweep_grid<TIER, V>(kernel, device, d, res);
  kernel<<<grid, TIER::threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(w), partials, ticket, out, n, d);
  return cudaGetLastError();
}
"""


def source(variants: list[tuple]) -> str:
    cases = []
    for i, (dt, nc, exact, cols, pipe, t, v) in enumerate(variants):
        typ = "float" if dt == "float" else "__nv_bfloat16"
        tier = (f"Tier<{nc}, 1, {str(exact).lower()}, {cols}, "
                f"{str(pipe).lower()}, {t}>")
        cases.append(f"    case {i}: return probe_one<{typ}, {tier}, {v}>("
                     f"op, w, partials, t, out, n, d, grid, stream, res);")
    csrc = os.path.join(ROOT, "src/repro_torch/kernels/csrc/pairwise_dist.cu")
    return (f'#include "{csrc}"\nnamespace {{\n{_ONE}}}  // namespace\n'
            'extern "C" int probe(int variant, int op, const void* w, '
            'float* partials, void* ticket, float* out, int n, long long d, '
            'int grid, void* stream, int* res) {\n'
            '  unsigned* t = static_cast<unsigned*>(ticket);\n'
            '  switch (variant) {\n' + "\n".join(cases) +
            '\n  }\n  return cudaErrorInvalidValue;\n}\n')


def build(tmp: str) -> list[tuple[ctypes.CDLL, int, tuple]]:
    """One library per (threads, dtype) group, all nvcc started together;
    returns (library, index in it, variant) for every variant."""
    from repro_torch.kernels import build as kbuild

    groups: dict[tuple, list[tuple]] = {}
    for var in VARIANTS:
        groups.setdefault((var[5], var[0], var[4] or var[2]), []).append(var)
    jobs = []
    for g, (key, vs) in enumerate(groups.items()):
        src = os.path.join(tmp, f"probe{g}.cu")
        with open(src, "w") as f:
            f.write(source(vs))
        out = os.path.join(tmp, f"libprobe{g}.so")
        jobs.append((out, vs, subprocess.Popen(
            [kbuild.nvcc_path(), *kbuild.FLAGS, "-o", out, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    found = []
    for out, vs, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"pairwise_cap_probe: nvcc failed:\n{log}")
        lib = ctypes.CDLL(out)
        lib.probe.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                              ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_int,
                              ctypes.c_void_p, ctypes.c_void_p]
        lib.probe.restype = ctypes.c_int
        found += [(lib, i, v) for i, v in enumerate(vs)]
    return found


def label(var: tuple) -> str:
    dt, nc, exact, cols, pipe, t, v = var
    kind = "exact" if exact else "general"
    return (f"{kind} N cap {nc} {t} threads {'pipelined ' if pipe else ''}"
            f"V={v} {'f32' if dt == 'float' else 'bf16'}")


def main() -> int:
    import torch

    from repro_torch.kernels import ref, reg_sweep

    if not torch.cuda.is_available():
        print("pairwise_cap_probe: no CUDA device is available",
              file=sys.stderr)
        return 1
    print(chip_smoke.card_line())
    with tempfile.TemporaryDirectory() as tmp:
        kernels = build(tmp)
        res = (ctypes.c_int * 2)()
        fits = []
        for lib, i, var in kernels:
            err = lib.probe(i, 0, None, None, None, None, 0, 0, 0, None, res)
            if err:
                raise SystemExit(f"pairwise_cap_probe: attributes: {err}")
            print(f"probe {label(var)}: {res[0]} registers, {res[1]} bytes "
                  f"of local memory")
            if res[1] == 0 and var[0] == "float" and var[6] > 1:
                fits.append((lib, i, var))
        stream = torch.cuda.current_stream().cuda_stream
        ticket = reg_sweep.ticket(torch.device("cuda", 0), stream)
        for d, v in ((MAIN_D, 2), (chip_smoke.BIG_D, 4)):
            g = torch.Generator(device="cuda").manual_seed(0)
            w = torch.randn((16, d), generator=g, device="cuda")
            for lib, i, var in (k for k in fits if k[2][6] == v):
                nc = var[1]
                for n in sorted({10, nc}):
                    wn = w[:n]
                    if lib.probe(i, 1, None, None, None, None, n, d, 0, None,
                                 res):
                        raise SystemExit(f"pairwise_cap_probe: grid "
                                         f"{label(var)}")
                    grid = res[0]
                    pairs = nc * (nc - 1) // 2
                    partials = torch.empty(pairs * grid, device="cuda")
                    out = torch.empty((n, n), device="cuda")

                    def call():
                        e = lib.probe(i, 2, wn.data_ptr(),
                                      partials.data_ptr(), ticket.data_ptr(),
                                      out.data_ptr(), n, d, grid, stream, res)
                        if e:
                            raise SystemExit(f"pairwise_cap_probe: launch "
                                             f"{label(var)}: {e}")
                    call()
                    torch.cuda.synchronize()
                    want = ref.pairwise_sq_dists(wn)
                    _, rel = chip_smoke.rel_err(out, want)
                    ok = (rel <= chip_smoke.TOL and torch.equal(out, out.T)
                          and bool(torch.all(torch.diagonal(out) == 0)))
                    ms = chip_smoke.time_ms(call)
                    clean = chip_smoke.time_ms(call, clean=True)
                    bound = (4 * n * d + 4 * n * n) / chip_smoke.PEAK_BYTES
                    print(f"probe time {label(var)} N={n} D={d}: "
                          f"{ms * 1e3:.3f} us, clean L2 {clean * 1e3:.3f} us, "
                          f"bound {bound * 1e6:.3f} us "
                          f"({100 * bound * 1e3 / ms:.1f}%), grid {grid}, "
                          f"err / max {rel:.2e}, checks {'ok' if ok else 'FAIL'}")
                    del want
            del w
            torch.cuda.empty_cache()
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
