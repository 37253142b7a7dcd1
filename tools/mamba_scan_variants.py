"""Time the ``mamba_scan`` CUDA kernel against variants of itself on one
NVIDIA card, at falcon-mamba-7b's serving shape (B, S, d_inner, d_state) =
(4, 3000, 8192, 16):

    python3 tools/mamba_scan_variants.py

Run from a checkout's root on a machine with the card, ``nvcc`` and
CUDA-enabled torch (no JAX needed). Each variant is
``src/repro_torch/kernels/csrc/mamba_scan.cu`` with one change of text,
built by its own ``nvcc`` (all started together) into
``build/mamba_scan_variants/``:

* ``kernel`` — the source as it is;
* ``expf`` — exp(Δ·a) by ``expf`` instead of ``ex2.approx`` of Δ·a·log₂e;
* ``no_loads`` — no tile is copied after the first two, so the kernel
  computes and stores y without reading u, Δ, b or c: its compute and
  stores alone;

and ``copy``, a plain kernel that reads u and Δ and writes y = u·Δ, 12
bytes an element, the bytes the scan must move. Prints each kernel's
registers and spills, the SASS opcodes of the shipped kernel's unrolled
16-step loop (its first to its last ``MUFU``) per step, each variant's
median time over 20 launches (CUDA events, twice each, in turns) with its
error against the plain version, and the SM clock and power while the
shipped kernel runs back to back for 3 s.
"""

from __future__ import annotations

import ctypes
import re
import statistics
import subprocess
import sys
import threading
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SHAPE = (4, 3000, 8192, 16)
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "mamba_scan.cu"
OUT = ROOT / "build" / "mamba_scan_variants"
COPY = """
__global__ void copy_kernel(const float4* __restrict__ u, const float4* __restrict__ dt,
                            float4* __restrict__ y, size_t n4) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const float4 a = u[i], b = dt[i];
    y[i] = make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
  }
}
extern "C" int copy_f32(const void* u, const void* dt, void* y, long long n, int blocks,
                        void* stream) {
  copy_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>((const float4*)u, (const float4*)dt,
                                                        (float4*)y, n / 4);
  return (int)cudaGetLastError();
}
"""


def variants(src: str) -> dict:
    """name -> source text; each edit must change the text."""
    edits = {
        "kernel": [],
        "expf": [("ex2_approx(dv * a2[n])", "expf(dv * a2[n])"),
                 ("constexpr float kLog2e = 1.4426950408889634f;",
                  "constexpr float kLog2e = 1.0f;")],
        "no_loads": [("if (kn < tiles) {", "if (kn < 0) {")],
    }
    out = {}
    for name, pairs in edits.items():
        text = src
        for old, new in pairs:
            if old not in text:
                sys.exit(f"variant {name}: '{old}' is not in {SOURCE.name}")
            text = text.replace(old, new)
        out[name] = text
    out["copy"] = COPY
    return out


def build(sources: dict) -> dict:
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        (OUT / f"{name}.cu").write_text(text)
        cmd = [_build._nvcc(), *_build._FLAGS, "-o", str(OUT / f"lib{name}.so"),
               str(OUT / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc {name} failed:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
        libs[name] = ctypes.CDLL(str(OUT / f"lib{name}.so"))
    return libs


def loop_opcodes() -> None:
    """Opcodes a step of the shipped kernel's unrolled loop: from its first
    to its last MUFU, over the 16 steps the loop unrolls."""
    from repro_torch.kernels import _build

    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(OUT / "libkernel.so")],
                          capture_output=True, text=True).stdout
    (OUT / "kernel.sass").write_text(sass)
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        ops = [m.group(1).split(".")[0] for m in re.finditer(
            r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", func)]
        mufu = [i for i, op in enumerate(ops) if op == "MUFU"]
        if not mufu:
            continue
        loop = Counter(ops[mufu[0]:mufu[-1] + 1])
        total = sum(loop.values())
        top = ", ".join(f"{op} {n / 16:.2f}" for op, n in loop.most_common(12))
        print(f"sass {func.split(chr(10), 1)[0].strip()[-60:]}: {total / 16:.2f} instructions "
              f"a step ({top})", flush=True)


def main() -> None:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.mamba_scan.plain import mamba_scan_plain

    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    libs = build(variants(SOURCE.read_text()))
    loop_opcodes()
    argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    for name, lib in libs.items():
        fn = lib.copy_f32 if name == "copy" else lib.mamba_scan_f32
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
                       if name == "copy" else argtypes)
        fn.restype = ctypes.c_int

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    b, s, di, ds = SHAPE
    u = torch.randn((b, s, di), generator=gen, device=dev)
    dt = F.softplus(-4.6 + torch.randn((b, s, di), generator=gen, device=dev))
    a = -(torch.arange(1, ds + 1, device=dev, dtype=torch.float32)[None]
          * torch.exp(0.1 * torch.randn((di, ds), generator=gen, device=dev)))
    bm = torch.randn((b, s, ds), generator=gen, device=dev)
    cm = torch.randn((b, s, ds), generator=gen, device=dev)
    y_ref, h_ref = mamba_scan_plain(u, dt, a, bm, cm)
    y, h = torch.empty_like(u), torch.empty((b, di, ds), device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def call(name):
        if name == "copy":
            return libs[name].copy_f32(u.data_ptr(), dt.data_ptr(), y.data_ptr(), u.numel(),
                                       16 * sms, stream)
        return libs[name].mamba_scan_f32(u.data_ptr(), dt.data_ptr(), a.data_ptr(),
                                         bm.data_ptr(), cm.data_ptr(), y.data_ptr(),
                                         h.data_ptr(), b, s, di, ds, 1, stream)

    def median_ms(name, reps=20):
        for _ in range(3):
            call(name)
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(3_000_000)
            start.record()
            call(name)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    nbytes = 4 * (3 * b * s * di + 2 * b * s * ds + di * ds + b * di * ds)
    names = list(libs)
    for name in names + names[::-1]:
        y.fill_(float("nan"))
        h.fill_(float("nan"))
        if call(name) != 0:
            sys.exit(f"{name}: launch failed")
        torch.cuda.synchronize()
        if name in ("kernel", "expf"):
            err_y = float((y - y_ref).abs().max()) / max(1.0, float(y_ref.abs().max()))
            err_h = float((h - h_ref).abs().max()) / max(1.0, float(h_ref.abs().max()))
            errs = f"rel err y {err_y:.3e} h_last {err_h:.3e}"
            if not max(err_y, err_h) <= 1e-4:
                sys.exit(f"{name}: disagrees with the plain version ({errs})")
        else:
            errs = "(no check)"
        ms = median_ms(name)
        print(f"{name:9s} {ms:.5f} ms {nbytes / ms / 1e6:7.1f} GB/s {errs}", flush=True)

    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                  "--format=csv,noheader"], capture_output=True, text=True)
            samples.append(out.stdout.strip())
            time.sleep(0.2)

    thread = threading.Thread(target=sample)
    thread.start()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 3.0:
        for _ in range(200):
            call("kernel")
        torch.cuda.synchronize()
    stop.set()
    thread.join()
    print("SM clock, power under load:", "; ".join(samples[1:-1]), flush=True)


if __name__ == "__main__":
    main()
