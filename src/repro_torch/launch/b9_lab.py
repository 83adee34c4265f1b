"""Kernel B9's wgmma form under the knife: ablations, occupancy and a
per-tile clock timeline, on the card.

    python -m repro_torch.launch.b9_lab [--variants base,no_softmax,...] [--timeline]

Each variant is a copy of ``kernels/csrc/flash_attention.cu`` with a few
lines replaced (``VARIANTS``), built by its own ``nvcc`` (all at once, into
``build/b9_lab/``, with ``-Xptxas -v``: the wgmma kernels' registers and
spills are printed) and loaded in place of the real library. A variant whose
name does not start with ``no_`` computes the same function and is first
held against the plain version at head dims 64, 80, 128 and 256 (3e-2 and
2^-6 of the largest |plain|); the ``no_`` ones skip part of the work, so
their outputs are wrong and only their times mean anything. Every variant
then times the wgmma form at the prefill shapes of ``SHAPES`` (the served
models' own) by CUDA events between back-to-back launches and by the
profiler's kernel time; ``base`` also times SDPA on the same inputs.
``--timeline`` builds ``base`` with ``clock64`` stamps at each step of the
first warp of each warpgroup in block 0's first work item and prints the
mean clocks a key tile spends in each step. A wgmma mbarrier wait that polls
2^28 times traps instead of hanging the card. Nothing here is on a model
path; the port never imports this module."""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
import time

LAB = os.path.join(os.path.dirname(os.path.abspath(__file__)), *[os.pardir] * 3, "build",
                   "b9_lab")
_TRAP = [("  uint32_t done;\n  do {", "  uint32_t done;\n  long long polls = 0;\n  do {"),
         ("  } while (!done);\n}", "    if (++polls > (1ll << 28)) __trap();\n  } while (!done);\n}")]
VARIANTS = {
    "base": [],
    # one resident block an SM at hd 64 and 80 (their 64-key tiles kept)
    "one_block": [("static constexpr int BLOCKS = HD <= 80 ? 2 : 1;",
                   "static constexpr int BLOCKS = 1;")],
    # no online softmax: P is S rounded to bf16
    "no_softmax": [("        const bool moved = softmax_wg<NB>(a, s, m, l, corr, rlo, rhi, "
                    "lo + t * BKN, t4);", "        const bool moved = false;")],
    # the softmax with each ex2 replaced by an FFMA
    "no_ex2": [("      const float p = exp2_approx(fmaf(s[0][n][i], sl2, nm[i >> 1]));",
                "      const float p = fmaf(fmaf(s[0][n][i], sl2, nm[i >> 1]), 1e-3f, 0.5f);")],
    # no K/V bytes: each "full" barrier completes on a bare arrival
    "no_loads": [("    mbar_expect_tx(full + 8 * s, T::TILE);",
                  "    asm volatile(\"mbarrier.arrive.shared::cta.b64 _, [%0];\\n\" "
                  "::\"r\"(full + 8 * s) : \"memory\");\n    return;"),],
}
_STEPS = ["wait K, V", "turn", "issue S + PV", "wait S", "softmax", "wait PV", "rescale, pack",
          "to next"]
_TIMELINE = [
    ("namespace {\n", "namespace {\n__device__ long long g_lab[2][32][8];\n"
     "#define LAB(k) if (lab_on && t < 32) g_lab[cw][t][k] = clock64();\n"),
    ("        mbar_wait(full_k + 8 * st, ((it + t) / S) & 1);",
     "        LAB(0) mbar_wait(full_k + 8 * st, ((it + t) / S) & 1);"),
    ("        turn();\n        wg_fence();\n        issue_s(st);",
     "        LAB(1) turn();\n        LAB(2) wg_fence();\n        issue_s(st);"),
    ("        pass(false);\n        wg_wait<1>();", "        pass(false);\n        LAB(3) wg_wait<1>();"),
    ("        release_k(st);\n        const bool moved", "        LAB(4) release_k(st);\n        const bool moved"),
    ("        wg_wait<0>();                    // P V of tile t - 1",
     "        LAB(5) wg_wait<0>();                    // P V of tile t - 1"),
    ("        if (moved) rescale();\n        pack_p();\n      }",
     "        LAB(6) if (moved) rescale();\n        pack_p();\n        LAB(7)\n      }"),
    ("    if (ntiles > 0) {\n      if (cw == 1)",
     "    const bool lab_on = blockIdx.x == 0 && ct == 0 && w == (int)blockIdx.x;\n"
     "    if (ntiles > 0) {\n      if (cw == 1)"),
    ('extern "C" int repro_flash_attention(',
     'extern "C" int lab_read(long long* h) { return (int)cudaMemcpyFromSymbol(h, g_lab, '
     'sizeof(g_lab)); }\nextern "C" int lab_clear() { static long long z[2 * 32 * 8]; '
     'return (int)cudaMemcpyToSymbol(g_lab, z, sizeof(g_lab)); }\n'
     'extern "C" int repro_flash_attention('),
]
# (tag, B, Sq, H, Skv, Hkv, hd, causal, extra kwargs): the served models' prefills
SHAPES = [
    ("TinyLlama prefill", 8, 512, 32, 512, 4, 64, True, {}),
    ("MusicGen self MHA", 8, 512, 32, 512, 32, 64, True, {}),
    ("vision self", 8, 512, 32, 512, 8, 128, True, {}),
    ("vision cross", 8, 512, 32, 1601, 8, 128, False, {}),
    ("Zamba2 hd 80", 8, 512, 32, 512, 32, 80, True, {}),
    ("Gemma2 hd 256", 8, 512, 16, 512, 8, 256, True, dict(window=4096, softcap=50.0)),
    ("Granite-20B prefill", 8, 512, 48, 512, 1, 128, True, {}),
]


def _so(name):
    return os.path.join(LAB, f"libfa_{name}.so")


def build(names, timeline):
    """Build every variant at once; print ptxas's lines for the wgmma kernels."""
    from repro_torch.kernels import build as kb
    os.makedirs(LAB, exist_ok=True)
    src0 = open(os.path.join(kb.CSRC, "flash_attention.cu")).read()
    jobs = {}
    for name in names + (["timeline"] if timeline else []):
        src = src0
        for old, new in _TRAP + (_TIMELINE if name == "timeline" else VARIANTS[name]):
            if old not in src:
                raise RuntimeError(f"variant {name}: the source no longer holds {old[:60]!r}")
            src = src.replace(old, new)
        path = os.path.join(LAB, f"fa_{name}.cu")
        open(path, "w").write(src)
        cmd = [kb.nvcc_path(), *kb.NVCC_FLAGS, "-Xptxas", "-v", "-o", _so(name), path]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True), time.perf_counter())
    for name, (p, t0) in jobs.items():
        out, err = p.communicate()
        print(f"[b9-lab] {name}: nvcc {time.perf_counter() - t0:.1f} s, exit {p.returncode}",
              flush=True)
        kernel = None
        for ln in (out + err).splitlines():
            m = re.search(r"wgmma_kernelILi(\d+)E", ln)
            if "Compiling entry function" in ln:
                kernel = m.group(1) if m else None
            elif kernel and ("registers" in ln or "spill" in ln):
                print(f"  hd {kernel}: {ln.split(':', 1)[-1].strip()}", flush=True)
        if p.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{err[-3000:]}")


def _use(fa, name):
    from repro_torch.kernels import flash_attention as tfa
    lib = ctypes.CDLL(_so(name))
    f = lib.repro_flash_attention
    f.argtypes = ([ctypes.POINTER(tfa._Plan)] + [ctypes.c_void_p] * 4
                  + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                     ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_void_p, ctypes.c_void_p])
    f.restype = ctypes.c_int
    fa._FN = f
    return lib


def _inputs(torch, g, dev, B, Sq, H, Skv, Hkv, hd):
    bf = torch.bfloat16
    return (torch.randn(B, Sq, H, hd, generator=g, device=dev).to(bf),
            torch.randn(B, Skv, Hkv, hd, generator=g, device=dev).to(bf),
            torch.randn(B, Skv, Hkv, hd, generator=g, device=dev).to(bf))


def check(torch, fa, ref, dev):
    """The wgmma form against the plain version at each head dim: causal
    and cross, G 1 / 4 / 48, off the row tile, window + softcap, NaN past
    kv_len and below kv_start bit-equal to zeros. Returns the worst error."""
    g = torch.Generator(device=dev).manual_seed(5)
    worst = 0.0
    for hd in (64, 80, 128, 256):
        cases = [((2, 129, 4, 129, 4, hd), dict(causal=True)),
                 ((2, 300, 8, 1601, 2, hd), dict(causal=False)),
                 ((2, 17, 48, 17, 1, hd), dict(causal=True)),
                 ((1, 300, 8, 300, 2, hd), dict(causal=True, window=100, softcap=50.0))]
        for shape, kw in cases:
            q, k, v = _inputs(torch, g, dev, *shape)
            n = fa.FORM_LAUNCHES["wgmma"]
            got = fa.flash_attention(q, k, v, **kw)
            want = ref.attention(q, k, v, causal=kw["causal"], window=kw.get("window", 0),
                                 logit_softcap=kw.get("softcap", 0.0))
            err = float((got.float() - want.float()).abs().max())
            tol = min(3e-2, 2 ** -6 * float(want.float().abs().max()))
            if fa.FORM_LAUNCHES["wgmma"] != n + 1 or not err <= tol:
                raise RuntimeError(f"hd {hd} {shape} {kw}: err {err} (tolerance {tol})")
            worst = max(worst, err)
        q, k, v = _inputs(torch, g, dev, 4, 100, 32, 320, 4, hd)
        start = torch.tensor([150, 3, 0, 199], dtype=torch.int32, device=dev)
        rows = torch.arange(320, device=dev)[None, :, None, None]
        bad = (rows < start.reshape(4, 1, 1, 1)) | (rows >= 290)
        i32 = (lambda x: torch.tensor(x, dtype=torch.int32, device=dev))
        kw = dict(causal=True, q_offset=i32(200), kv_len=i32(290), kv_start=start)
        z = fa.flash_attention(q, k.masked_fill(bad, 0), v.masked_fill(bad, 0), **kw)
        nan = fa.flash_attention(q, k.masked_fill(bad, float("nan")),
                                 v.masked_fill(bad, float("inf")), **kw)
        if not torch.equal(z.view(torch.int16), nan.view(torch.int16)):
            raise RuntimeError(f"hd {hd}: garbage outside [kv_start, kv_len) changed the output")
    return worst


def _events(torch, fn, reps=60, warm=10):
    for _ in range(warm):
        fn()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    ev[0].record()
    for i in range(reps):
        fn()
        ev[i + 1].record()
    torch.cuda.synchronize()
    ts = sorted(ev[i].elapsed_time(ev[i + 1]) for i in range(reps))
    return ts[reps // 2]


def _device(torch, fn, match, n=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.end - e.time_range.start for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and match in e.name]
        if len(us) >= n:
            return sum(us) / n / 1e3
    return None


def run_variant(name, sdpa):
    """Check (unless an ablation) and time one variant: its own process."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa, ref
    _use(fa, name)
    dev = torch.device("cuda")
    if not name.startswith("no_"):
        print(f"[b9-lab] {name}: vs plain version, hd 64 / 80 / 128 / 256: max abs err "
              f"{check(torch, fa, ref, dev):.3e}; garbage bit-equal to zeros", flush=True)
    g = torch.Generator(device=dev).manual_seed(1)
    for tag, B, Sq, H, Skv, Hkv, hd, causal, kw in SHAPES:
        q, k, v = _inputs(torch, g, dev, B, Sq, H, Skv, Hkv, hd)
        fn = (lambda: fa.flash_attention(q, k, v, causal=causal, **kw))
        ms, dms = _events(torch, fn), _device(torch, fn, "wgmma")
        flops = 4 * B * H * hd * (Sq * (Sq + 1) / 2 if causal else Sq * Skv)
        line = (f"[b9-lab] {name}: {tag}: events {ms:.4f} ms, device "
                + ("not measured" if dms is None else
                   f"{dms:.4f} ms ({flops / dms / 1e9:.0f} TFLOP/s)"))
        if sdpa:
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            sfn = (lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                          enable_gqa=True))
            sd = _device(torch, sfn, "")
            line += (f"; SDPA events {_events(torch, sfn):.4f} ms, device "
                     + ("not measured" if sd is None else f"{sd:.4f} ms")
                     + (" (no softcap, no window)" if kw else ""))
        print(line, flush=True)


def run_timeline():
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as fa
    lib = _use(fa, "timeline")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    print("[b9-lab] timeline: mean clocks a key tile (tiles 1 on of block 0's first item), "
          "by step: " + ", ".join(_STEPS), flush=True)
    for tag, B, Sq, H, Skv, Hkv, hd, causal, kw in SHAPES[:4]:
        q, k, v = _inputs(torch, g, dev, B, Sq, H, Skv, Hkv, hd)
        torch.cuda.synchronize()
        if lib.lab_clear() != 0:   # no stamps of another shape's launches
            raise RuntimeError("clearing the timeline failed")
        for _ in range(5):
            fa.flash_attention(q, k, v, causal=causal, **kw)
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * (2 * 32 * 8))()
        if lib.lab_read(buf) != 0:
            raise RuntimeError("reading the timeline failed")
        d = np.array(buf[:], dtype=np.int64).reshape(2, 32, 8)
        for wg in range(2):
            rows = [list(np.diff(d[wg, t])) + [d[wg, t + 1, 0] - d[wg, t, 7]]
                    for t in range(1, 31) if d[wg, t, 0] and d[wg, t + 1, 0]]
            if rows:
                r = np.array(rows, dtype=np.float64)
                print(f"[b9-lab] timeline {tag}, warpgroup {wg}, {len(rows)} tiles: "
                      + ", ".join(f"{x:.0f}" for x in r.mean(0))
                      + f"; a tile {r.sum(1).mean():.0f} clocks", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--timeline", action="store_true")
    ap.add_argument("--run", help=argparse.SUPPRESS)   # one variant, in a process of its own
    args = ap.parse_args(argv)
    if args.run:
        if args.run == "timeline":
            run_timeline()
        else:
            run_variant(args.run, args.run == "base")
        return
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("b9_lab needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[b9-lab] {smi.stdout.strip()}", flush=True)
    names = [n for n in args.variants.split(",") if n]
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: {sorted(VARIANTS)}")
    build(names, args.timeline)
    failed = []
    for name in names + (["timeline"] if args.timeline else []):
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.b9_lab", "--run", name])
        if r.returncode:
            failed.append(name)
    if failed:
        raise SystemExit(f"b9_lab: {failed} failed")


if __name__ == "__main__":
    main()
