"""Time the attention bodies at other tile and block sizes.

Builds copies of ``csrc/attention_qkv_{fwd,bwd}.cu`` in which one of the
compile-time sizes of a tensor-core body is changed (bf16: the chunk of
keys a forward warp holds in registers, the warps per block, the rows a
backward warp sweeps at a time, the bf16 terms that carry dS; the
key-chunked ring bodies' consumer warps, buffers, least blocks an SM and
backward step width, per padded head width (the backward's at Dp <= 64
share one set), and the backward's key tiles a block and warps a key
tile at 128 and 256; f32: the
warps per block of the whole-sequence bodies, the tiles a backward step
takes; or ``{fwd,bwd}_f32_small=int``: the small TF32 part rounded by the
integer add and mask instead of cvt.rna, csrc/attention_tf32.cuh), and
times each against the source as it is on the same inputs, in turns,
with its worst error against the plain version:

    python -m hgr_tpu_torch.tools.tune_attention [--batch 64 256]
        [--n 785] [--heads 16 --head_dim 16] [--dtype float32]
        [--grid ring] [--variants knob=value ...]

Needs the card and nvcc. Prints one JSON line per (variant, batch) and,
first, one per build (registers, spills).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess

# knob -> (source, the start of the line that sets it)
KNOBS = {
    "fwd_chunk_tiles": ("attention_qkv_fwd", "constexpr int kChunkTiles = "),
    "fwd_warps": ("attention_qkv_fwd", "constexpr int kFwdWarps = "),
    "bwd_tiles": ("attention_qkv_bwd", "constexpr int kBwdTiles = "),
    "bwd_warps": ("attention_qkv_bwd", "constexpr int kBwdWarps = "),
    "bwd_split": ("attention_qkv_bwd", "constexpr int kSplit = "),
    "bwd_ring_warps": ("attention_qkv_bwd", "constexpr int kRingWarps = "),
    "bwd_ring_stages": ("attention_qkv_bwd", "constexpr int kRingStages = "),
    "bwd_ring_blocks": ("attention_qkv_bwd", "constexpr int kRingBlocks = "),
    "bwd_ring_tiles": ("attention_qkv_bwd", "constexpr int kRingTiles = "),
    "f32_fwd_warps": ("attention_qkv_fwd", "constexpr int kF32Warps = "),
    "f32_bwd_warps": ("attention_qkv_bwd", "constexpr int kF32Warps = "),
    "f32_tiles": ("attention_qkv_bwd", "constexpr int kF32Tiles = "),
    # the forward's ring body, per padded head width (fwd_ring_warps16 ...)
    **{f"fwd_ring_{knob}{dp}": ("attention_qkv_fwd",
                                f"constexpr int kRing{name}{dp} = ")
       for dp in (16, 32, 64, 128, 256)
       for knob, name in (("warps", "Warps"), ("stages", "Stages"),
                          ("blocks", "Blocks"), ("piece", "Piece"))},
    # the backward's ring pair at padded head widths 128 and 256
    # (bwd_ring_warps128 ...: query tiles a block, key tiles a block,
    # warps a key tile, buffers, rows a chunk, tiles a step, least blocks
    # an SM of the query and the key kernel; roles and blocks at 128 only)
    **{f"bwd_ring_{knob}{dp}": ("attention_qkv_bwd",
                                f"constexpr int kRing{name}{dp} = ")
       for dp in (128, 256)
       for knob, name in (("warps", "Warps"), ("keytiles", "KeyTiles"),
                          ("roles", "Roles"), ("stages", "Stages"),
                          ("rows", "Rows"), ("tiles", "Tiles"),
                          ("blocks", "Blocks"), ("keyblocks", "KeyBlocks"))
       if dp == 128 or knob not in ("roles", "blocks", "keyblocks")},
}
# knob -> (source, header, the text it replaces); value "int" only: the
# small TF32 part by the integer form of cvt.rna (which turns a NaN of x
# into -0: faster, not safe)
HEADER_KNOBS = {
    f"{kind}_f32_small": (f"attention_qkv_{kind}", "attention_tf32.cuh",
                          re.compile(r'asm\("cvt\.rna\.tf32\.f32 %0, %1;\\n" '
                                     r':\s*"=r"\(small\)\s*:\s*"f"\(x - '
                                     r'__uint_as_float\(big\)\)\);'))
    for kind in ("fwd", "bwd")}
_SMALL_INT = ("small = (__float_as_uint(x - __uint_as_float(big)) + "
              "0x1000u) & 0xffffe000u;")
DEFAULT_GRID = {
    "bfloat16": ["fwd_chunk_tiles=10", "fwd_warps=2", "fwd_warps=4",
                 "fwd_warps=8", "bwd_tiles=4", "bwd_warps=8", "bwd_split=2"],
    # the key-chunked route's ring bodies (run with --n 785)
    "ring": ["fwd_ring_warps32=8", "fwd_ring_stages32=3",
             "fwd_ring_piece32=2", "bwd_ring_warps=8", "bwd_ring_stages=4",
             "bwd_ring_tiles=2", "bwd_ring_blocks=1"],
    # the forward's ring body at head widths 16 and 64 (run with --n 785
    # --heads 16 --head_dim 16, or --heads 4 --head_dim 64)
    "ring16": ["fwd_ring_stages16=4,fwd_ring_blocks16=3",
               "fwd_ring_blocks16=3", "fwd_ring_warps16=8",
               "fwd_ring_piece16=2", "fwd_ring_stages16=2",
               "fwd_ring_warps16=3,fwd_ring_stages16=2,fwd_ring_blocks16=6"],
    "ring64": ["fwd_ring_stages64=2", "fwd_ring_piece64=2",
               "fwd_ring_warps64=6", "fwd_ring_warps64=8",
               "fwd_ring_warps64=5,fwd_ring_stages64=2,fwd_ring_blocks64=3"],
    # the ring bodies at padded head widths 128 and 256 (run with --n 785
    # --batch 16 --heads 2 --head_dim 128, or 256)
    "ring128": ["fwd_ring_piece128=6", "fwd_ring_stages128=2",
                "bwd_ring_tiles128=4,bwd_ring_blocks128=1",
                "bwd_ring_roles128=2,bwd_ring_keytiles128=3,"
                "bwd_ring_keyblocks128=2",
                "bwd_ring_stages128=2"],
    "ring256": ["fwd_ring_piece256=2",
                "fwd_ring_stages256=2", "bwd_ring_stages256=3",
                "bwd_ring_tiles256=2", "bwd_ring_keytiles256=2"],
    "float32": ["f32_fwd_warps=8", "f32_bwd_warps=4", "f32_tiles=2",
                "fwd_f32_small=int", "bwd_f32_small=int"],
}


def _variant_source(spec: str) -> tuple:
    """(source name, its text with the knob set, {header: patched text})
    for ``knob=value`` (or ``knob=value,knob2=value2`` of one source); the
    unchanged source for 'as-is:<source>'."""
    from hgr_tpu_torch.utils.cuda_build import CSRC_DIR

    if spec.startswith("as-is:"):
        name = spec.split(":", 1)[1]
        return name, (CSRC_DIR / f"{name}.cu").read_text(), {}
    knob, value = spec.split(",")[0].split("=")
    if knob in HEADER_KNOBS:
        name, header, pattern = HEADER_KNOBS[knob]
        text = (CSRC_DIR / header).read_text()
        if value != "int" or not pattern.search(text):
            raise ValueError(f"{spec}: takes =int, and csrc/{header} must "
                             "round small with cvt.rna")
        return name, (CSRC_DIR / f"{name}.cu").read_text(), {
            header: pattern.sub(_SMALL_INT, text)}
    # one knob, or several of one source joined by commas
    names, text = set(), None
    for part in spec.split(","):
        knob, value = part.split("=")
        name, prefix = KNOBS[knob]
        names.add(name)
        if text is None:
            text = (CSRC_DIR / f"{name}.cu").read_text()
        found = re.search(re.escape(prefix) + r"\d+;", text)
        if found is None or len(names) > 1:
            raise ValueError(f"{spec}: {prefix!r} not in csrc/{name}.cu, "
                             "or knobs of two sources")
        text = text.replace(found.group(0), f"{prefix}{int(value)};")
    return name, text, {}


def _build(specs) -> dict:
    """spec -> (source name, loaded library, ptxas lines); all nvcc runs
    started together."""
    from hgr_tpu_torch.utils.cuda_build import (
        BUILD_DIR, CSRC_DIR, NVCC_FLAGS, _nvcc)

    out_dir = BUILD_DIR / "tune"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, spec in enumerate(specs):
        name, text, headers = _variant_source(spec)
        # a variant's own directory: a patched header there is found
        # before csrc/'s (quoted includes search the source's directory)
        var_dir = out_dir / f"v{i}"
        var_dir.mkdir(exist_ok=True)
        for header in {h.name for h in CSRC_DIR.glob("*.cuh")} - set(headers):
            (var_dir / header).unlink(missing_ok=True)
        for header, patched in headers.items():
            (var_dir / header).write_text(patched)
        src = var_dir / f"{name}.cu"
        src.write_text(text)
        lib = src.with_suffix(".so")
        procs[spec] = (name, lib, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    built = {}
    for spec, (name, lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            if spec.startswith("as-is:"):
                raise RuntimeError(f"nvcc failed for {spec}:\n{log}")
            # a variant that does not build is reported and left out
            print(json.dumps({"build": spec, "failed": log[-2000:]}),
                  flush=True)
            continue
        ptxas = [f"{entry}: {used}; {spills}"
                 for entry, spills, used in re.findall(
                     r"Compiling entry function '(\w+)'.*?"
                     r"(\d+ bytes spill stores).*?(Used \d+ registers)",
                     log, flags=re.S)
                 if "mma" in entry or "tf32" in entry]
        built[spec] = (name, ctypes.CDLL(str(lib)), ptxas)
    return built


def _code(t) -> int:
    import torch

    return 0 if t.dtype == torch.float32 else 1


def _scratch(lib, b: int, n: int, heads: int, head_dim: int, qkv):
    """The backward's statistics scratch at lengths past the
    whole-sequence route (None below)."""
    import torch

    fn = lib.attention_qkv_bwd_scratch_floats
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_longlong
    count = fn(b, n, heads, head_dim, _code(qkv))
    return (torch.empty(count, dtype=torch.float32, device=qkv.device)
            if count else None)


def _call(name: str, lib, qkv, g, out, heads: int, head_dim: int,
          stream) -> None:
    b, n, _ = qkv.shape
    scale = head_dim ** -0.5
    c = ctypes
    if name == "attention_qkv_fwd":
        fn = lib.attention_qkv_fwd
        fn.argtypes = [c.c_void_p, c.c_void_p] + [c.c_int] * 4 + [
            c.c_float, c.c_int, c.c_void_p]
        rc = fn(qkv.data_ptr(), out.data_ptr(), b, n, heads, head_dim,
                scale, _code(qkv), stream)
    else:
        fn = lib.attention_qkv_bwd
        fn.argtypes = [c.c_void_p] * 4 + [c.c_int] * 4 + [
            c.c_float, c.c_int, c.c_void_p]
        scratch = _scratch(lib, b, n, heads, head_dim, qkv)
        rc = fn(qkv.data_ptr(), g.data_ptr(), out.data_ptr(),
                None if scratch is None else scratch.data_ptr(), b, n, heads,
                head_dim, scale, _code(qkv), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed ({rc})")


def _time_ms(torch, fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    import torch

    from hgr_tpu_torch.ops import attention as A

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[64, 256])
    ap.add_argument("--n", type=int, default=145)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--head_dim", type=int, default=32)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--variants", nargs="+", default=None,
                    help="knob=value, knobs: " + ", ".join(
                        [*KNOBS, *HEADER_KNOBS]) + " (default: the "
                    "dtype's grid)")
    ap.add_argument("--grid", choices=sorted(DEFAULT_GRID), default=None,
                    help="a default grid of variants (default: the "
                    "dtype's; 'ring': the key-chunked ring bodies; 'ring16', "
                    "'ring64': the forward's ring body at those widths; "
                    "'ring128', 'ring256': both ring bodies at those widths)")
    args = ap.parse_args(argv)
    variants = args.variants or DEFAULT_GRID[args.grid or args.dtype]
    if not torch.cuda.is_available():
        raise SystemExit("tune_attention needs a CUDA card")
    specs = ["as-is:attention_qkv_fwd", "as-is:attention_qkv_bwd", *variants]
    built = _build(specs)
    specs = [spec for spec in specs if spec in built]
    for spec, (_, _, ptxas) in built.items():
        print(json.dumps({"build": spec, "ptxas": ptxas}), flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    h, d = args.heads, args.head_dim
    for b in args.batch:
        dt = getattr(torch, args.dtype)
        qkv = torch.randn(b, args.n, 3 * h * d, device="cuda",
                          generator=gen).to(dt)
        g = torch.randn(b, args.n, h * d, device="cuda", generator=gen).to(dt)
        refs = {"attention_qkv_fwd": A.attention_qkv_reference(
                    qkv, h, d, d ** -0.5),
                "attention_qkv_bwd": A.attention_qkv_bwd_reference(
                    qkv, g, h, d, d ** -0.5)}
        rows = {}
        # in turns: every variant, then every variant again in reverse
        for spec in specs + specs[::-1]:
            name, lib, _ = built[spec]
            out = torch.empty_like(refs[name])

            def fn():
                _call(name, lib, qkv, g, out, h, d, stream)

            ms = _time_ms(torch, fn, 50 if name.endswith("fwd") else 20)
            row = rows.setdefault(spec, {"variant": spec, "kernel": name,
                                         "dtype": args.dtype, "batch": b,
                                         "n": args.n, "heads": h,
                                         "head_dim": d, "runs_ms": []})
            row["runs_ms"].append(ms)
            row["max_abs_err"] = (out.float() - refs[name].float()).abs(
            ).max().item()
        for row in rows.values():
            row["ms"] = sum(row["runs_ms"]) / len(row["runs_ms"])
            print(json.dumps(row), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
