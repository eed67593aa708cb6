"""Device-only times, bounds and edge cases of the port's kernels.

    python -m orbslam3_tpu_torch.kernel_bench INPUTS.pt
    python -m orbslam3_tpu_torch.kernel_bench --sass

The first times the kernels of whichever `orbslam3_tpu_torch` is imported
on the inputs that `chip_smoke.py --save-inputs INPUTS.pt` wrote (B2 on the
EuRoC atlas, B1 at the main path's five calls), and prints one JSON line per
kernel and call. The second builds the kernel library and prints, per
kernel, its SASS instructions by opcode (`cuobjdump -sass`) and its
registers and shared memory (`cuobjdump -res-usage`). Both use only the
wrappers' public API and the loaded library, so the same file, copied into
an older checkout of the package, measures that checkout's kernels.

How a kernel is timed (`device_us`): K calls of its wrapper are captured into
one CUDA graph (the wrappers launch through `ctypes` on the current stream,
so the capture holds the kernels and nothing else), the graph is replayed
between two CUDA events, and the elapsed time is divided by K. That is the
device's time per launch, without the host's work between launches. The
inputs stay in L2 (about 1 MB against 50 MB), as they are for the main
path's caller, which has just written them. `call_us` is the time of one
wrapper call between two events, host work included: what the main path pays
per call. `profiler_us` is the kernels' own device time under
`torch.profiler`, a cross-check of `device_us`.

Bounds (`b1_bound`, `b2_bound`) are the least time of the same work on an
H100 SXM: the bytes read once and written once at 3.35 TB/s, or the
operations this call's data needs at the card's peak rate for their type.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
# `__popc`: 16 per SM per clock (compute capability 9.0), 132 SMs, 1.98 GHz.
POPC_PER_S = 132 * 16 * 1.98e9
# float32 outside the tensor cores: 128 lanes per SM per clock (the data
# sheet's 67 TFLOP/s counts a fused multiply-add as two).
FP32_OPS_PER_S = 132 * 128 * 1.98e9
# B2's float32 operations per atlas pixel: per ring tap 4 threshold compares
# and, for each of the two score sums, 2 subtractions, a max and an add; 4
# thresholds per pixel; 9 maxima for the NMS (integer bit work not counted).
B2_FP32_OPS_PER_PIXEL = 16 * (4 + 2 * 4) + 4 + 9

GRAPH_CALLS = 50  # K: calls captured in one graph


def sm_clock_mhz() -> Optional[int]:
    """The card's SM clock now, as nvidia-smi reads it (None without it)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30, check=True)
        return int(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def device_us(fn: Callable[[], object], calls: int = GRAPH_CALLS, reps: int = 5,
              warm_ms: float = 50.0) -> Tuple[float, Optional[int]]:
    """(median device time of one call of `fn` in us, SM clock in MHz), by
    CUDA-graph replay. Replays run back to back: `warm_ms` of them first, so
    the card leaves its idle clocks, then `reps` timed ones, then more while
    nvidia-smi reads the clock they ran at."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):  # build, allocator, one-time launch setup
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 2)]
    ev[0].record()
    graph.replay()
    ev[1].record()
    ev[1].synchronize()
    n_warm = math.ceil(warm_ms / max(ev[0].elapsed_time(ev[1]), 1e-3))
    for _ in range(n_warm):
        graph.replay()
    for i in range(reps + 1):
        ev[i].record()
        if i < reps:
            graph.replay()
    for _ in range(4 * n_warm):
        graph.replay()
    mhz = sm_clock_mhz()
    torch.cuda.synchronize()
    del graph
    times = [ev[i].elapsed_time(ev[i + 1]) * 1e3 / calls for i in range(reps)]
    return statistics.median(times), mhz


def launch_floor_us() -> Tuple[float, Optional[int]]:
    """Device time of a one-element PyTorch kernel by the same method: the
    least a launch costs on this card."""
    x = torch.zeros(1, device="cuda")
    return device_us(lambda: x.add_(1.0))


def call_us(fn: Callable[[], object], iters: int = 20, warmup: int = 3) -> float:
    """Median time of one call of `fn` in us, CUDA events around each call
    (the host's work before the launch included)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) * 1e3)
    return statistics.median(times)


def profiler_us(fn: Callable[[], object], names, calls: int = GRAPH_CALLS
                ) -> Tuple[Optional[float], Dict[str, float]]:
    """(device time per call of the kernels whose names contain one of
    `names`, under `torch.profiler`, None when the profiler saw none;
    launches per call of each of those names it saw)."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total, seen = 0.0, {}
    for e in prof.key_averages():
        name = next((n for n in names if n in e.key), None)
        if e.device_type == DeviceType.CUDA and name is not None:
            total += e.self_device_time_total
            seen[name] = seen.get(name, 0) + e.count / calls
    return (total / calls if total > 0 else None), seen


def _bound(nbytes: float, ops: float, ops_per_s: float) -> Dict[str, object]:
    byte_us, op_us = nbytes / HBM_BYTES_PER_S * 1e6, ops / ops_per_s * 1e6
    return {"bytes": int(nbytes), "ops": int(ops), "byte_us": byte_us, "op_us": op_us,
            "bound_us": max(byte_us, op_us), "bound_by": "bytes" if byte_us >= op_us else "operations"}


def b1_bound(desc_a, desc_b, valid_b=None, window=None) -> Dict[str, object]:
    """B1's least time: inputs and outputs once; 8 popcounts per valid key
    in each query's window (counted from the plain window mask)."""
    from orbslam3_tpu_torch.ops import matching

    n, m = desc_a.shape[0], desc_b.shape[0]
    nbytes = 32 * (n + m) + 12 * n + (m if valid_b is not None else 0)
    ok = torch.ones(m, dtype=torch.bool, device=desc_a.device) if valid_b is None else valid_b
    if window is None:
        pairs = n * int(ok.sum())
    else:
        r = window.radius_q
        nbytes += 8 * n + 8 * m + 4 * m + 8 * n + 4 * (1 if r.dim() == 0 or r.stride(0) == 0 else n)
        mask = matching.window_mask(window.uv_q, window.uv_k, r, window.octave_k,
                                    window.octave_lo, window.octave_hi)
        pairs = int((mask & ok[None, :]).sum())
    out = _bound(nbytes, 8 * pairs, POPC_PER_S)
    out["pairs"] = pairs
    return out


def b2_bound(atlas: torch.Tensor) -> Dict[str, object]:
    """B2's least time: the f32 atlas in, the f32 score and bool pass_ini
    out; B2_FP32_OPS_PER_PIXEL float32 operations per pixel."""
    px = atlas.numel()
    return _bound(4 * px + 5 * px, B2_FP32_OPS_PER_PIXEL * px, FP32_OPS_PER_S)


B1_KERNEL_NAMES = ("hamming_top2_kernel",)
# B2's one kernel, and the two of its first version (a launch each), so that
# this file profiles an older checkout's B2 too.
B2_KERNEL_NAMES = ("fast_nms_tile_kernel", "fast_score_kernel", "nms3_kernel")


def _time(fn: Callable[[], object], names) -> Dict[str, object]:
    dev_us, mhz = device_us(fn)
    prof_us, launched = profiler_us(fn, names)
    return {"device_us": dev_us, "sm_mhz": mhz, "call_us": call_us(fn), "profiler_us": prof_us,
            "profiler_launches_per_call": launched}


def time_b1(args) -> Dict[str, object]:
    """Device, call and profiler time of one B1 call on `args`."""
    from orbslam3_tpu_torch.ops import cuda_match

    return _time(lambda: cuda_match.hamming_top2(*args), B1_KERNEL_NAMES)


def time_b2(atlas, min_th, ini_th) -> Dict[str, object]:
    """Device, call and profiler time of one B2 call on the atlas."""
    from orbslam3_tpu_torch.ops import cuda_fast

    return _time(lambda: cuda_fast.fast_score_nms(atlas, min_th, ini_th), B2_KERNEL_NAMES)


# --- What the compiler made of the kernels ---------------------------------


def _cuda_tool(name: str) -> str:
    return shutil.which(name) or f"/usr/local/cuda/bin/{name}"


def _kernel_name(mangled: str) -> Optional[str]:
    """The kernel of B1_/B2_KERNEL_NAMES that a mangled function name holds,
    with its template arguments (`hamming_top2_kernel<true,16,false>`)."""
    for base in B1_KERNEL_NAMES + B2_KERNEL_NAMES:
        m = re.search(re.escape(base) + r"(?:I((?:L[bi]\d+E)+)E)?", mangled)
        if m:
            args = re.findall(r"L([bi])(\d+)E", m.group(1) or "")
            vals = [("true" if v == "1" else "false") if t == "b" else v for t, v in args]
            return base + (f"<{','.join(vals)}>" if vals else "")
    return None


def sass_report(lib_path: str) -> Dict[str, Dict[str, object]]:
    """Per kernel function of the library at `lib_path` (by `_kernel_name`):
    its SASS instruction count, the count by opcode (modifiers dropped; NOP
    padding excluded), and its registers and shared memory as `cuobjdump
    -res-usage` reports them."""
    sass = subprocess.run([_cuda_tool("cuobjdump"), "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    res = subprocess.run([_cuda_tool("cuobjdump"), "-res-usage", lib_path], capture_output=True,
                         text=True, check=True).stdout
    head_re = re.compile(r"Function\s*:?\s*([^\s:]+)")
    out: Dict[str, Dict[str, object]] = {}
    fn = None
    for line in sass.splitlines():
        head = head_re.search(line)
        if head:
            fn = _kernel_name(head.group(1))
            if fn is not None:
                out[fn] = {"instructions": 0, "by_opcode": {}}
            continue
        op = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if fn is None or op is None or op.group(1) == "NOP":
            continue
        rec = out[fn]
        rec["instructions"] += 1
        rec["by_opcode"][op.group(1)] = rec["by_opcode"].get(op.group(1), 0) + 1
    for line in res.splitlines():
        head = head_re.search(line)
        if head:
            fn = _kernel_name(head.group(1))
            continue
        usage = re.search(r"REG:(\d+).*SHARED:(\d+)", line)
        if usage and fn in out:
            out[fn]["registers"] = int(usage.group(1))
            out[fn]["shared_bytes"] = int(usage.group(2))
    return out


# --- Inputs saved by chip_smoke.py, loaded here --------------------------


def b1_record(label: str, args) -> Dict[str, object]:
    """One B1 call's inputs, on the host, in a form any version of the
    package can load."""
    desc_a, desc_b, valid_b, window = args
    cpu = lambda x: None if x is None else x.detach().cpu()  # noqa: E731
    return {"label": label, "desc_a": cpu(desc_a), "desc_b": cpu(desc_b),
            "valid_b": cpu(valid_b), "window": None if window is None else [cpu(w) for w in window]}


def b1_args(rec: Dict[str, object], device):
    from orbslam3_tpu_torch.ops import cuda_match

    dev = lambda x: None if x is None else x.to(device)  # noqa: E731
    window = rec["window"]
    if window is not None:
        window = cuda_match.MatchWindow(*(dev(w) for w in window))
    return dev(rec["desc_a"]), dev(rec["desc_b"]), dev(rec["valid_b"]), window


# --- B1's edge cases -------------------------------------------------------


def b1_edge_cases(seed: int = 0) -> List[Dict[str, object]]:
    """Inputs (numpy) on which kernel B1 must equal its plain version, and
    the plain version the reference's XLA path, on every row: NaN and
    infinite query and key positions, negative, zero and wider-than-image
    radii, keys at exactly |du| = r and |dv| = r and one ulp beyond, M = 1
    and 2, all keys invalid, many duplicate descriptors, and query counts
    that are no multiple of any block size. Each case is a dict of da, db,
    vb and (windowed) uvq, uvk, rad, octk, lo, hi."""
    rng = np.random.default_rng(seed)
    W, H = 160.0, 120.0

    def make(n, m, n_desc=None, windowed=True, rad=(2.0, 14.0)):
        pool = rng.integers(0, 256, (n_desc or m, 32), dtype=np.uint8)
        db = pool[rng.integers(0, len(pool), m)] if n_desc else pool
        src = rng.integers(0, m, n)
        flips = (rng.random((n, 32, 8)) < 0.05).astype(np.uint8)
        da = db[src] ^ np.packbits(flips, axis=-1, bitorder="little")[..., 0]
        c = {"da": da, "db": db, "vb": rng.random(m) > 0.15}
        if windowed:
            uvk = (rng.uniform(0, 1, (m, 2)) * [W, H]).astype(np.float32)
            octk = rng.integers(0, 8, m).astype(np.int32)
            lo = np.clip(octk[src] - 1, 0, None).astype(np.int32)
            c.update(uvq=(uvk[src] + rng.normal(0, 3, (n, 2))).astype(np.float32), uvk=uvk,
                     rad=rng.uniform(*rad, n).astype(np.float32), octk=octk, lo=lo,
                     hi=(lo + 2).astype(np.int32))
        return c

    cases = []
    c = make(37, 300)  # NaN and infinite positions, negative and infinite radii
    inf, nan = np.float32(np.inf), np.float32(np.nan)
    c["uvq"][:8] = [[nan, 5], [5, nan], [nan, nan], [inf, 5], [-inf, 5], [inf, inf],
                    [-inf, -inf], [1e30, 1e30]]
    c["rad"][8:12] = [inf, -1.0, nan, inf]
    c["uvq"][11] = [inf, 60]  # |inf - x| = inf <= inf for every finite key
    c["lo"][8:12], c["hi"][8:12] = 0, 7
    c["uvk"][:4] = [[nan, 10], [inf, 10], [-inf, 20], [30, inf]]
    cases.append(("nan_inf", c))

    c = make(133, 500)  # radius 0: only keys exactly at the query pass
    c["rad"][:] = 0.0
    c["uvq"][::2] = c["uvk"][rng.integers(0, 500, 67)]
    c["lo"][:], c["hi"][:] = 0, 7
    cases.append(("radius_0", c))

    c = make(65, 1024, rad=(200.0, 1e6))  # windows wider than the image
    cases.append(("radius_wide", c))

    c = make(96, 400)  # keys at exactly |du| = r and |dv| = r, and one ulp beyond
    q = np.round(c["uvq"][:48] * 4) / 4
    r = np.float32(4.25)
    c["uvq"][:48], c["rad"][:48] = q, r
    sgn = rng.choice([-1.0, 1.0], (48, 2)).astype(np.float32)
    edge = (q + sgn * r).astype(np.float32)  # exact: quarter-pixel values
    beyond = np.nextafter(edge, edge + sgn, dtype=np.float32)
    c["uvk"][:48], c["uvk"][48:96] = edge, beyond
    c["octk"][:96], c["lo"][:48], c["hi"][:48] = 2, 1, 3
    c["vb"][:96] = True
    cases.append(("window_edge", c))

    for m in (1, 2):
        for windowed in (True, False):
            c = make(70, m, windowed=windowed, rad=(20.0, 80.0))
            c["vb"][:] = True
            cases.append((f"m{m}_{'windowed' if windowed else 'all'}", c))

    for windowed in (True, False):
        c = make(50, 256, windowed=windowed)
        c["vb"][:] = False
        cases.append((f"all_invalid_{'windowed' if windowed else 'all'}", c))

    for windowed in (True, False):  # 4 distinct descriptors: ties at every distance
        c = make(257, 1000, n_desc=4, windowed=windowed, rad=(10.0, 60.0))
        cases.append((f"duplicates_{'windowed' if windowed else 'all'}", c))

    for n in (1, 31, 129, 1031):
        cases.append((f"n{n}", make(n, 777, rad=(4.0, 40.0))))
    return cases


def b1_tile_cases(seed: int = 1) -> List[Tuple[str, Dict[str, np.ndarray]]]:
    """Inputs (numpy) with more keys than one 1024-key tile, on which kernel
    B1 must equal its plain version on every row: M = 1025, 2000 and 4097,
    windowed at N = 16384 and N = 1024 and unwindowed at N = 1024, keys
    spread uniformly over a 752 x 480 image; and ties across a tile edge ("tile_tie_*": M = 2048, the keys of the
    second tile copies of the first, so every best is tied between k and
    k + 1024; query 0 is key 5's descriptor at key 5's position, so its j1
    is 5, never 1029)."""
    rng = np.random.default_rng(seed)
    W, H = 752.0, 480.0

    def make(n, m, windowed):
        db = rng.integers(0, 256, (m, 32), dtype=np.uint8)
        src = rng.integers(0, m, n)
        flips = (rng.random((n, 32, 8)) < 0.05).astype(np.uint8)
        da = db[src] ^ np.packbits(flips, axis=-1, bitorder="little")[..., 0]
        da[: n // 4] = rng.integers(0, 256, (n // 4, 32), dtype=np.uint8)
        c = {"da": da, "db": db, "vb": rng.random(m) > 0.1}
        if windowed:
            uvk = (rng.uniform(0, 1, (m, 2)) * [W, H]).astype(np.float32)
            octk = rng.integers(0, 8, m).astype(np.int32)
            lo = np.clip(octk[src] - 1, 0, None).astype(np.int32)
            c.update(uvq=(uvk[src] + rng.normal(0, 4, (n, 2))).astype(np.float32), uvk=uvk,
                     rad=rng.uniform(4.0, 60.0, n).astype(np.float32), octk=octk, lo=lo,
                     hi=(lo + 2).astype(np.int32))
        return c

    cases = []
    for m in (1025, 2000, 4097):
        for n, windowed in ((16384, True), (1024, True), (1024, False)):
            cases.append((f"m{m}_n{n}_{'windowed' if windowed else 'all'}", make(n, m, windowed)))
    for windowed in (True, False):
        c = make(1024, 2048, windowed)
        for k in ("db", "vb", "uvk", "octk"):
            if k in c:
                c[k][1024:] = c[k][:1024]
        c["vb"][5] = True
        c["da"][0] = c["db"][5]
        if windowed:
            c["uvq"][0], c["lo"][0], c["hi"][0] = c["uvk"][5], 0, 7
        cases.append((f"tile_tie_{'windowed' if windowed else 'all'}", c))
    return cases


def b1_case_args(case: Dict[str, np.ndarray], device):
    """The wrapper's arguments for one edge case, on `device`."""
    from orbslam3_tpu_torch.ops import cuda_match

    t = lambda x: torch.from_numpy(np.array(x, copy=True)).to(device)  # noqa: E731
    window = None
    if "uvq" in case:
        window = cuda_match.MatchWindow(*(t(case[k]) for k in ("uvq", "uvk", "rad", "octk",
                                                                 "lo", "hi")))
    return t(case["da"]), t(case["db"]), t(case["vb"]), window


# --- B2's cases -------------------------------------------------------------


def b2_cases(seed: int = 0) -> List[Tuple[str, np.ndarray]]:
    """Images (float32) on which kernel B2 must equal its plain version on
    every pixel: smaller than one 64 x 32 tile and than its 4-px halo (1x1,
    5x300, 300x5, 7x7, 17x65), one tile and a pixel each way (33x65), non-integer
    values (where r > c + th and (r - c) > th round differently), and
    plateaus: small bright and dark blocks on a flat background, whose
    pixels see the same ring (so equal scores sit side by side and the NMS
    must keep them all), some cut by the border, where the flat background
    next to the zero padding makes rows of equal scores too."""
    rng = np.random.default_rng(seed)
    cases = [(f"{h}x{w}", np.round(rng.uniform(0, 255, (h, w))).astype(np.float32))
             for h, w in ((1, 1), (5, 300), (300, 5), (7, 7), (17, 65), (33, 65))]
    cases.append(("fractional_33x70", rng.uniform(0, 255, (33, 70)).astype(np.float32)))
    img = np.full((64, 200), 100.0, np.float32)
    sizes = [(1, 1), (2, 2), (3, 3), (2, 1), (1, 3)]
    for k, (y, x) in enumerate((y, x) for y in range(0, 64, 9) for x in range(0, 200, 9)):
        h, w = sizes[k % len(sizes)]
        img[y : y + h, x : x + w] = 220.0 if k % 2 else 10.0
    cases.append(("plateau", img))
    return cases


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Time or disassemble the port's kernels")
    ap.add_argument("inputs", nargs="?", help="inputs saved by chip_smoke.py --save-inputs")
    ap.add_argument("--sass", action="store_true",
                    help="print SASS instruction counts, registers and shared memory per kernel")
    opts = ap.parse_args(argv)
    if (opts.inputs is None) == (not opts.sass) or not torch.cuda.is_available():
        ap.print_usage(sys.stderr)
        print("give INPUTS.pt or --sass (a CUDA device is needed)", file=sys.stderr)
        return 1
    from orbslam3_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    lib = _build.library()
    if opts.sass:
        for name, rec in sass_report(lib._name).items():
            print(json.dumps({"kernel": name, **rec}))
        return 0
    saved = torch.load(opts.inputs)
    floor_us, mhz = launch_floor_us()
    print(json.dumps({"kernel": "one-element add (launch floor)", "device_us": floor_us,
                      "sm_mhz": mhz}))
    b2 = saved["b2"]
    atlas = b2["atlas"].to(dev)
    print(json.dumps({"kernel": "fast_nms", "call": "EuRoC atlas", "shape": list(atlas.shape),
                      **time_b2(atlas, b2["min_th"], b2["ini_th"])}))
    for rec in saved["b1"]:
        args = b1_args(rec, dev)
        print(json.dumps({"kernel": "hamming_top2", "call": rec["label"],
                          "shape": [args[0].shape[0], args[1].shape[0]],
                          "windowed": args[3] is not None, **time_b1(args)}))
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
