"""A/B of the f32 forms' accuracy and device time across checkouts, and
across variants of this checkout's f32 tile (csrc/block_f32.cuh).

Each checkout is given as LABEL=PATH (the package under PATH, built there
into PATH/build/kernels); each variant of this checkout's tile is built in
a copy under build/f32_tile_ab.  Variants of ``mma3``: "running_sum" (the
three TF32 passes summed straight into the caller's accumulator, so that a
long k keeps its running sum in the tensor cores' accumulator) and
"running_sum_4pass" (that, with the fourth pass a_small b_small too).

One worker process on the card per checkout or variant, one after
another: each f32 form against its plain version at the (N, C, H) of
ACCURACY_SHAPES (chip_smoke._f32_block_checks: each check's error over its
limit, flat and clamp weights), and, for the labels named by --times, B1
f32 (a forward) and B2 f32 (a train step) at the flagship's and wide384's
full row counts: device ms by kernel from a profiler trace of one call
after a warm-up, summed over the calls of a forward or step.

    python -m tfswa_tpu_torch.tools.f32_tile_ab P=build/parent C=. \\
        --variants running_sum,running_sum_4pass --times P,C,running_sum \\
        --out build/f32_tile_ab.json
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
F32_LIBS = ["fused_block_f32", "fused_block_bwd_f32", "row_attention_f32"]
# (train, N, C, H): the edge grid's C = 512, the flagship's stage 3 and
# stage 0, wide384's stage 3
ACCURACY_SHAPES = [(True, 64, 512, 1), (True, 129, 512, 2), (True, 64, 256, 8),
                   (True, 1025, 32, 8), (True, 64, 384, 4), (True, 128, 384, 4),
                   (False, 64, 512, 1), (False, 64, 256, 8), (False, 1024, 32, 8),
                   (False, 128, 384, 4)]
MMA3_BODY = ("    float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};\n"
             "    mma_tf32(t, a[1], b[0]);\n"
             "    mma_tf32(t, a[0], b[1]);\n"
             "    mma_tf32(t, a[0], b[0]);\n"
             "#pragma unroll\n"
             "    for (int i = 0; i < 4; ++i) d[i] += t[i];\n")
VARIANTS = {
    "running_sum": ("    mma_tf32(d, a[1], b[0]);\n"
                    "    mma_tf32(d, a[0], b[1]);\n"
                    "    mma_tf32(d, a[0], b[0]);\n"),
    "running_sum_4pass": ("    mma_tf32(d, a[1], b[1]);\n"
                          "    mma_tf32(d, a[1], b[0]);\n"
                          "    mma_tf32(d, a[0], b[1]);\n"
                          "    mma_tf32(d, a[0], b[0]);\n"),
}


def make_variant(name: str) -> Path:
    """A copy of this checkout's package with mma3's body replaced by
    VARIANTS[name]; the copy's root."""
    dst = ROOT / "build" / "f32_tile_ab" / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "tfswa_tpu_torch", dst / "tfswa_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    hdr = dst / "tfswa_tpu_torch" / "csrc" / "block_f32.cuh"
    src = hdr.read_text()
    if src.count(MMA3_BODY) != 1:
        raise RuntimeError("mma3's body is not the one this tool patches")
    hdr.write_text(src.replace(MMA3_BODY, VARIANTS[name]))
    return dst


def build(root: Path) -> None:
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from tfswa_tpu_torch.ops import _build; _build.build(sys.argv[2:])")
    subprocess.run([sys.executable, "-c", code, str(root), *F32_LIBS], check=True)


def worker(root: str, times: bool) -> dict:
    root = str(Path(root).resolve())
    sys.path.insert(0, root)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import tfswa_tpu_torch
    if not Path(tfswa_tpu_torch.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {tfswa_tpu_torch.__file__}, not the package under {root}")
    from torch.profiler import ProfilerActivity, profile, schedule

    from tfswa_tpu_torch.models.attention import RowBlockParams
    from tfswa_tpu_torch.ops import fused_block as fb

    out = {"gpu": cs.gpu_line(), "errors": {}, "times": {}}
    gen = torch.Generator().manual_seed(15)
    for train, N, C, H in ACCURACY_SHAPES:
        checks, _ = cs._f32_block_checks(torch, N, C, gen, train, H=H, hidden=4 * C)
        row = {}
        for regime, c in checks.items():
            for ch in c["checks"]:
                if ch["tol"] and "plain" not in ch["name"]:
                    row[f"{regime} {ch['name']}"] = ch["err"] / ch["tol"]
        out["errors"][f"{'train' if train else 'serve'} N={N} C={C} H={H}"] = row

    def split(run):
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                run()
                torch.cuda.synchronize()
                prof.step()
        res = {}
        for key, ms, _ in cs.device_kernels(prof)[0]:
            n = cs.kernel_name_of(key)
            res[n] = res.get(n, 0.0) + ms
        return res

    cells = (("flagship", cs.HEADS, cs.SHAPES, cs.TRAIN_SHAPES),
             ("wide384", cs.WIDE384["num_heads"], cs.WIDE_SHAPES, cs.WIDE_TRAIN_SHAPES))
    for cell, H, serve, trn in cells if times else ():
        for kind, table in (("B1", serve), ("B2", trn)):
            tot, total_ms = {}, 0.0
            for stage, _, N, C, R in table:
                calls = cs.BLOCKS_PER_STAGE[stage]
                p = cs.random_params(torch, RowBlockParams, C, gen)
                cg = torch.Generator(device="cuda").manual_seed(N * C)
                x = torch.randn((R, N, C), device="cuda", generator=cg)
                if kind == "B1":
                    def run():
                        return fb.fused_row_block(x, p, H)
                else:
                    _, mid, acc, den = fb.fused_row_block_train(x, p, H)
                    g = torch.randn((R, N, C), device="cuda", generator=cg)

                    def run():
                        return fb.fused_row_block_bwd(x, mid, acc, den, g, p, H)
                total_ms += calls * cs.cuda_ms(torch, run, 1)
                for n, ms in split(run).items():
                    tot[n] = tot.get(n, 0.0) + calls * ms
                del x, run
                torch.cuda.empty_cache()
            out["times"][f"{cell} {kind}"] = {"ms": total_ms, "by_kernel": tot}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", nargs="*", help="LABEL=PATH, each a checkout's root")
    ap.add_argument("--variants", default="", help="comma-separated names of VARIANTS")
    ap.add_argument("--times", default="", help="comma-separated labels to time")
    ap.add_argument("--out", default="build/f32_tile_ab.json")
    ap.add_argument("--worker", nargs=2, metavar=("ROOT", "TIMES"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker[0], args.worker[1] == "1")))
        return
    roots = dict(c.split("=", 1) for c in args.checkouts)
    for v in filter(None, args.variants.split(",")):
        roots[v] = str(make_variant(v))
    timed = set(filter(None, args.times.split(",")))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(roots)) as pool:
        list(pool.map(build, map(Path, roots.values())))
    print(f"builds: {time.perf_counter() - t0:.1f} s", flush=True)
    results = {}
    for label, root in roots.items():
        res = subprocess.run([sys.executable, __file__, "--worker", root,
                              "1" if label in timed else "0"],
                             check=True, stdout=subprocess.PIPE, text=True)
        results[label] = json.loads(res.stdout.strip().splitlines()[-1])
        for shape, row in results[label]["errors"].items():
            worst = max(row, key=row.get)
            print(f"{label} {shape}: worst {worst} {row[worst]:.4f} of its limit", flush=True)
        for cell, t in results[label]["times"].items():
            top = sorted(t["by_kernel"].items(), key=lambda kv: -kv[1])
            print(f"{label} {cell}: {t['ms']:.1f} ms; "
                  + ", ".join(f"{n} {ms:.1f}" for n, ms in top if ms >= 1.0), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
