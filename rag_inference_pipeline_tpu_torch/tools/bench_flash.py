"""The encoder's flash-attention kernel and the long-context encoder timed
alone, to compare checkouts.

    python3 rag_inference_pipeline_tpu_torch/tools/bench_flash.py [--out PATH] [--smoke]
        [--against REF [--sources-only]]

Imports `rag_inference_pipeline_tpu_torch` from the checkout this file sits
in, builds its kernels and times on one card, with seeded random inputs:

- `flash_encoder_attention` at each case of `chip_smoke.py::FLASH_CASES`
  (B = `FLASH_B`, rows cycling through the four mask kinds), by CUDA
  events over many calls, beside SDPA (`scaled_dot_product_attention` with
  the boolean segment-equality mask: a yardstick the port never calls),
  the tensor bound (4 B H T^2 Dh operations at 989 TFLOP/s; f32 runs six
  bf16 products of them) and the CUDA-core floor;
- `bert_embed` at bge-base width (random bf16 weights, `max_positions` the
  longest of `FLASH_PATH_T`) at each of `FLASH_PATH_T`, B = `FLASH_B`, ms a
  forward.

The CUDA-core floor of a case is the softmax and update work on the CUDA
cores: the FP32-pipe instructions (FADD, FMUL, FFMA, FMNMX, FSEL, FSETP,
F2FP) and the MUFU instructions of the main loop of the checkout's built
kernel for that dtype and Dh (f32: the split of p too), counted from its
SASS (`cuobjdump -sass`) on the path a block takes when every key shares
the row's segment, divided by the scores a thread handles an iteration;
times B H T^2 scores, over 132 SMs x 128 FP32 lanes (x 16 MUFU lanes) at
the SM clock that `nvidia-smi --query-gpu=clocks.max.sm` prints; the
larger of the two.

To compare two checkouts in one call on the same card, copy this file into
the other checkout's `rag_inference_pipeline_tpu_torch/tools/` and run both
in turns (parent, change, change, parent). Prints one JSON line and writes
it to `--out` (default `build/bench/flash.json`); needs a card. `--smoke`
runs every case and forward once on the CPU (the plain version, at a tiny
shape) and times nothing.

`--against REF` times the f32 kernel of git ref REF beside this
checkout's in one process instead, at `AGAINST_CASES`: REF's
`csrc/flash_attention.cu` (and the headers it includes) built by `nvcc`
into `build/against/REF/` and called through its C entry point, which has
not changed since the kernel was first written. Each case checks both
kernels against the plain version (`FLASH_TOL`) and times them in turns
(REF, this, this, REF) beside SDPA, with the bound and the floor.
REF's sources are read with `git show` into `build/against/REF/src/` the
first time; `--sources-only` stops there, so that a copy of the checkout
without its history (the card's machine) finds them.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PEAK_16BIT_OPS_PER_S = 989e12  # bf16 and f16 tensor cores, dense
# the f32 kernel's products: each a sum of six bf16 products of the three
# parts its operands split into (csrc/flash_attention.cu)
F32_PRODUCTS = 6
SMS, FP32_LANES, MUFU_LANES = 132, 128, 16  # an H100 SXM's SMs and lanes an SM
# the FP32-pipe opcodes the floor counts (SASS, before the first '.')
FP32_OPS = ("FADD", "FMUL", "FFMA", "FMNMX", "FSEL", "FSETP", "F2FP")
SMOKE_CASES = [(256, 2, 64, "bfloat16"), (256, 2, 64, "float32")]
# --against: the f32 cases (T, H, Dh) at B = chip_smoke.FLASH_B
AGAINST_CASES = [(1024, 12, 64), (2048, 12, 64), (4096, 12, 64), (1024, 6, 128), (1024, 3, 256)]
AGAINST_SOURCE = "rag_inference_pipeline_tpu_torch/csrc/flash_attention.cu"


def tensor_bound_ms(b: int, h: int, t: int, dh: int, f32: bool = False) -> float:
    """The two products' 4 B H T^2 Dh operations at the 16-bit tensor
    cores' peak rate, six times over in f32."""
    return 4.0 * b * h * t * t * dh * (F32_PRODUCTS if f32 else 1) / PEAK_16BIT_OPS_PER_S * 1e3


def cuda_core_floor_ms(b: int, h: int, t: int, fp32_per_score: float,
                       mufu_per_score: float, clock_mhz: float) -> float:
    """B H T^2 scores at `fp32_per_score` FP32-pipe instructions over 132 x
    128 lanes and `mufu_per_score` MUFU instructions over 132 x 16, at the
    SM clock; the larger of the two."""
    scores = float(b) * h * t * t
    hz = clock_mhz * 1e6
    return max(scores * fp32_per_score / (SMS * FP32_LANES * hz),
               scores * mufu_per_score / (SMS * MUFU_LANES * hz)) * 1e3


def _parse_sass(lines: list[str]) -> list[tuple[int, str, bool, int]]:
    """(address, opcode, predicated, branch target address or -1) a SASS
    instruction."""
    insts = []
    for line in lines:
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*(.*?);",
                     line)
        if m:
            target = re.match(r"(0x[0-9a-f]+)", m.group(4)) if m.group(3).startswith("BRA") else None
            insts.append((int(m.group(1), 16), m.group(3), m.group(2) is not None,
                          int(target.group(1), 16) if target else -1))
    return insts


def main_loop_counts(lines: list[str]) -> dict:
    """FP32-pipe and MUFU instructions of one kernel's main loop, from its
    SASS: the predicated backward branch whose span holds the most
    tensor-core products (HGMMA or HMMA; the shortest such span). Where the
    loop chooses between alternative blocks (an if / else-if / else: two or
    more blocks ending in an unconditional branch to one join, and the
    block that falls through to it), only the shortest alternative is
    counted: the scale-and-mask block of a key block whose ids all equal
    the rows' segment."""
    insts = _parse_sass(lines)
    index = {addr: i for i, (addr, *_) in enumerate(insts)}

    def mma(lo, hi):
        return sum(1 for _, op, _, _ in insts[lo:hi] if op.startswith(("HGMMA", "HMMA")))

    loops = [(index[t], i) for i, (addr, op, pred, t) in enumerate(insts)
             if op.startswith("BRA") and pred and 0 <= t <= addr and t in index]
    loops = [x for x in loops if mma(*x)]
    if not loops:
        raise ValueError("no loop over tensor-core products in the SASS")
    lo, hi = max(loops, key=lambda x: (mma(*x), x[0] - x[1]))
    # basic blocks of the loop: cut at branch targets and after branches
    cuts = sorted({lo, hi + 1}
                  | {index[t] for *_, t in insts if t in index and lo < index[t] <= hi}
                  | {i + 1 for i in range(lo, hi) if insts[i][1].startswith("BRA")})
    blocks = [(a, b) for a, b in zip(cuts, cuts[1:])]
    joins: dict[int, list] = {}
    for a, b in blocks:
        _, op, pred, t = insts[b - 1]
        if op.startswith("BRA") and not pred and t > insts[b - 1][0] and t in index:
            joins.setdefault(index[t], []).append((a, b))
    skipped = set()
    for join, alts in joins.items():
        if len(alts) < 2:
            continue
        alts = alts + [blk for blk in blocks if blk[1] == join]
        skipped |= set(alts) - {min(alts, key=lambda blk: blk[1] - blk[0])}

    def count(ops):
        return sum(1 for a, b in blocks if (a, b) not in skipped
                   for _, op, _, _ in insts[a:b] if op.split(".")[0] in ops)

    return {"fp32": count(FP32_OPS), "mufu": count(("MUFU",)),
            "loop_instructions": sum(b - a for a, b in blocks if (a, b) not in skipped),
            "skipped_alternatives": len(skipped)}


def flash_sass(lib_path: str) -> dict[str, list[str]]:
    """The SASS lines of each flash kernel of the built library, by mangled
    name (cuobjdump from the toolkit): the kernels' names from its resource
    listing, then only their SASS (the whole library's runs to tens of MB);
    the whole dump where that finds none."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    tool = os.path.join(cuda_home, "bin", "cuobjdump")
    usage = subprocess.run([tool, "-res-usage", lib_path], capture_output=True, text=True,
                           timeout=300, check=True).stdout
    names = sorted(set(re.findall(r"Function\s+(\S*flash_\S*?):", usage)))
    out = _sass_dump([tool, "-sass", "-fun", ",".join(names), lib_path]) if names else {}
    return out or _sass_dump([tool, "-sass", lib_path])


def _sass_dump(cmd: list[str]) -> dict[str, list[str]]:
    """The flash functions of a cuobjdump SASS listing, read as it streams."""
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    out, lines = {}, None
    try:
        for line in proc.stdout:
            name = re.match(r"\s*Function\s*:\s*(\S+)", line)
            if name:
                lines = out.setdefault(name.group(1), []) if "flash_" in name.group(1) else None
            elif lines is not None:
                lines.append(line)
    finally:
        proc.kill()
        proc.wait()
    return out


def per_score(sass: dict[str, list[str]], dtype_name: str, dh: int) -> dict:
    """FP32-pipe and MUFU instructions a score of the checkout's flash
    kernel for `dtype_name` at `dh`: its main loop handles 64 scores a
    consumer thread (64 rows x 128 keys a warpgroup), as the mma.sync
    kernel's warp handled 16 x 128 (Dh 256: two warps, each computing all
    64 scores)."""
    ctype = {"bfloat16": "13__nv_bfloat16", "float16": "6__half", "float32": ""}[dtype_name]
    names = [n for n in sass if re.search(rf"flash_\w*kernelI{ctype}Li{dh}E", n)]
    if len(names) != 1:
        raise ValueError(f"{len(names)} SASS functions for the {dtype_name} Dh {dh} kernel")
    counts = main_loop_counts(sass[names[0]])
    return {"fp32_per_score": counts["fp32"] / 64, "mufu_per_score": counts["mufu"] / 64,
            **counts}


def sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return float(out.strip().splitlines()[0])


def cuda_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bench_cases(cases, b: int, device: str, g, smoke: bool, sass, clock) -> dict:
    import chip_smoke
    import torch
    import torch.nn.functional as F
    from rag_inference_pipeline_tpu_torch.ops import flash_attention as fa

    out, counts = {}, {}
    for t, h, dh, dtype_name in cases:
        dtype = getattr(torch, dtype_name)
        q, k, v = (torch.randn((b, t, h, dh), generator=g, device=device).to(dtype)
                   for _ in range(3))
        seg = chip_smoke.flash_masks(b, t)
        f32 = dtype == torch.float32
        row = {"tensor_bound_ms": tensor_bound_ms(b, h, t, dh, f32)}
        if smoke:
            res = fa.flash_encoder_attention(q, k, v, seg, seg)
            row["finite"] = bool(torch.isfinite(res.float()).all())
        else:
            row["ms"] = cuda_ms(lambda: fa.flash_encoder_attention(q, k, v, seg, seg), 50)
            allowed = seg[:, None, :, None] == seg[:, None, None, :]
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            row["sdpa_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed), 50)
            row["library_over_kernel"] = row["sdpa_ms"] / row["ms"]
            row.update(floor_row(sass, counts, dtype_name, b, h, t, dh, clock, row))
            del allowed, qt, kt, vt
        out[f"t{t}_h{h}_d{dh}_{dtype_name}"] = row
        del q, k, v
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def floor_row(sass, counts: dict, dtype_name: str, b: int, h: int, t: int, dh: int,
              clock, row: dict) -> dict:
    """The CUDA-core floor of a timed case (`row` holds its `ms` and
    `tensor_bound_ms`) from the SASS counts, kept in `counts` by (dtype,
    Dh): `sass`, `cuda_core_floor_ms` and `of_floor`, the larger floor over
    the kernel's time; only `sass` (its error) where the count fails."""
    key = (dtype_name, dh)
    if key not in counts:
        try:
            counts[key] = per_score(sass, dtype_name, dh)
        except ValueError as err:
            counts[key] = {"error": repr(err)}
    c = counts[key]
    if "error" in c:
        return {"sass": c}
    floor = cuda_core_floor_ms(b, h, t, c["fp32_per_score"], c["mufu_per_score"], clock)
    return {"sass": c, "cuda_core_floor_ms": floor,
            "of_floor": max(row["tensor_bound_ms"], floor) / row["ms"]}


def ref_sources(ref: str, root: str = ROOT) -> str:
    """The directory that holds git ref `ref`'s flash source and the headers
    it includes (`build/against/REF/src` under `root`), read with `git show`
    the first time and found there after."""
    dest = os.path.join(root, "build", "against", ref, "src")
    name = os.path.basename(AGAINST_SOURCE)
    if os.path.exists(os.path.join(dest, name)):
        return dest
    os.makedirs(dest, exist_ok=True)
    csrc = os.path.dirname(AGAINST_SOURCE)
    todo, seen = [name], set()
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.add(f)
        got = subprocess.run(["git", "-C", root, "show", f"{ref}:{csrc}/{f}"],
                             capture_output=True, text=True)
        if got.returncode != 0:
            raise RuntimeError(f"no {csrc}/{f} at {ref} (a copy without the history needs "
                               f"--against {ref} --sources-only run first where it is): "
                               f"{got.stderr.strip()}")
        text = got.stdout
        with open(os.path.join(dest, f), "w") as fh:
            fh.write(text)
        todo += re.findall(r'^#include "([^"/]+)"', text, re.M)
    return dest


def build_ref(src_dir: str) -> str:
    """`nvcc` of REF's flash source alone into a shared library beside its
    sources; returns its path."""
    from rag_inference_pipeline_tpu_torch.ops import _kernels

    lib = os.path.join(os.path.dirname(src_dir), "libflash_ref.so")
    src = os.path.join(src_dir, os.path.basename(AGAINST_SOURCE))
    flags = [f for f in _kernels.COMPILE_FLAGS if f != "-c"]
    got = subprocess.run([_kernels._nvcc(), *flags, "-shared", "-o", lib, src],
                         capture_output=True, text=True)
    if got.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{got.stderr}")
    return lib


def ref_kernel(lib_path: str):
    """REF's flash kernel as a function of (q, k, v, seg): the wrapper's
    call of `ragtorch_flash_attention`, on the current stream."""
    import ctypes

    import torch
    from rag_inference_pipeline_tpu_torch.ops import flash_attention as fa

    lib = ctypes.CDLL(lib_path)
    fn = lib.ragtorch_flash_attention
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [vp] * 6 + [i32] * 4 + [i64] * 9 + [i32, vp]
    fn.restype = i32

    def call(q, k, v, seg):
        b, t, h, dh = q.shape
        out = torch.empty_like(q)
        sq = seg.to(torch.int32).contiguous()
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), sq.data_ptr(), sq.data_ptr(),
                out.data_ptr(), b, t, h, dh, *q.stride()[:3], *k.stride()[:3],
                *v.stride()[:3], fa._KINDS[q.dtype], torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the reference's ragtorch_flash_attention failed: {rc}")
        return out

    return call


def against(ref: str, b: int, g, sass, clock) -> dict:
    """This checkout's f32 kernel and `ref`'s at AGAINST_CASES: both held to
    the plain version, then timed in turns (ref, this, this, ref) beside
    SDPA, with the bound, the floor and each kernel's share of the bound."""
    import chip_smoke
    import torch
    import torch.nn.functional as F
    from rag_inference_pipeline_tpu_torch.ops import flash_attention as fa

    parent = ref_kernel(build_ref(ref_sources(ref)))
    atol, rtol = chip_smoke.FLASH_TOL["float32"]
    out, counts = {}, {}
    for t, h, dh in AGAINST_CASES:
        q, k, v = (torch.randn((b, t, h, dh), generator=g, device="cuda") for _ in range(3))
        seg = chip_smoke.flash_masks(b, t)
        want = fa.flash_encoder_attention_plain(q, k, v, seg, seg)
        row = {"tensor_bound_ms": tensor_bound_ms(b, h, t, dh, True)}
        kernels = {"ref": lambda: parent(q, k, v, seg),
                   "change": lambda: fa.flash_encoder_attention(q, k, v, seg, seg)}
        for name, fn in kernels.items():
            err = (fn() - want).abs()
            torch.cuda.synchronize()
            row[f"{name}_max_abs_err"] = err.max().item()
            row[f"{name}_within_tol"] = bool((err <= atol + rtol * want.abs()).all())
        del want, err
        torch.cuda.empty_cache()
        iters = max(3, 20 * 1024 * 1024 // (t * t))
        turns = [(name, cuda_ms(kernels[name], iters))
                 for name in ("ref", "change", "change", "ref")]
        allowed = seg[:, None, :, None] == seg[:, None, None, :]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        row["sdpa_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed), iters)
        for name in ("ref", "change"):
            row[f"{name}_ms"] = [ms for n, ms in turns if n == name]
        row["ms"] = max(row["change_ms"])
        row["of_bound"] = row["tensor_bound_ms"] / row["ms"]
        row["change_over_ref"] = min(row["ref_ms"]) / row["ms"]
        row["library_over_kernel"] = row["sdpa_ms"] / row["ms"]
        row.update(floor_row(sass, counts, "float32", b, h, t, dh, clock, row))
        out[f"t{t}_h{h}_d{dh}_float32"] = row
        del q, k, v, allowed, qt, kt, vt
        torch.cuda.empty_cache()
    return out


def bench_path(b: int, lengths, device: str, g, smoke: bool) -> dict:
    """bert_embed at bge-base width (tiny for --smoke), ms a forward."""
    import chip_smoke
    import torch
    from rag_inference_pipeline_tpu_torch.models import bert as tbert

    if smoke:
        cfg = tbert.BertConfig(vocab_size=512, hidden=128, layers=2, heads=2,
                               intermediate=256, max_positions=max(lengths))
    else:
        cfg = tbert.BertConfig(max_positions=max(lengths))
    params = tbert.init_bert_params(cfg, generator=g, dtype=torch.bfloat16, device=device)
    out = {}
    with torch.inference_mode():
        for t in lengths:
            mask = chip_smoke.flash_masks(b, t)
            ids = torch.randint(1, cfg.vocab_size, (b, t), generator=g, device=device) * mask
            if smoke:
                emb = tbert.bert_embed(params, cfg, ids, mask)
                out[f"t{t}"] = {"finite": bool(torch.isfinite(emb.float()).all())}
            else:  # an eager forward: the host's launches can set its pace
                tbert.bert_embed(params, cfg, ids, mask)
                out[f"t{t}"] = {"forward_ms": cuda_ms(
                    lambda: tbert.bert_embed(params, cfg, ids, mask), 10)}
    del params
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "bench", "flash.json"))
    ap.add_argument("--smoke", action="store_true",
                    help="every case and forward once on the CPU, at a tiny shape")
    ap.add_argument("--against", metavar="REF",
                    help="time git ref REF's f32 kernel beside this checkout's")
    ap.add_argument("--sources-only", action="store_true",
                    help="with --against: write REF's sources under build/against and stop")
    args = ap.parse_args(argv)
    if args.sources_only:
        if not args.against:
            ap.error("--sources-only goes with --against")
        return {"sources": ref_sources(args.against)}
    sys.path.insert(0, ROOT)
    import chip_smoke
    import torch

    if args.smoke:
        device, smi, sass, clock = "cpu", None, None, None
        cases, lengths = SMOKE_CASES, (256,)
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("bench_flash needs a CUDA card (or --smoke)")
        from rag_inference_pipeline_tpu_torch.ops import _kernels

        device = "cuda"
        sass = flash_sass(_kernels.build())
        _kernels.load_library()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
        clock = sm_clock_mhz()
        cases, lengths = chip_smoke.FLASH_CASES, chip_smoke.FLASH_PATH_T
    keep = chip_smoke.DEVICE
    chip_smoke.DEVICE = device
    try:
        g = torch.Generator(device=device).manual_seed(15)
        out = {"root": ROOT, "card": smi, "sm_clock_mhz": clock}
        if args.against:
            out["against"] = args.against
            out["cases"] = against(args.against, chip_smoke.FLASH_B, g, sass, clock)
        else:
            out["cases"] = bench_cases(cases, chip_smoke.FLASH_B, device, g, args.smoke,
                                       sass, clock)
            out["bert_embed"] = bench_path(chip_smoke.FLASH_B, lengths, device, g, args.smoke)
    finally:
        chip_smoke.DEVICE = keep
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=2)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
