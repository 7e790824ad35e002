"""Sweep the launch shapes of the kernels on the card: the tile sizes of
`best_node` and `best_node_batched`, the cluster size and threads a CTA
of `coarse_pass`.

    python -m cook_tpu_torch.tile_sweep [--out tile_sweep.jsonl]
                                        [--kernels coarse_pass ...]

Run from the repository root (it takes its inputs from `chip_smoke.py`'s
case makers).  Each variant — a tile of TJ jobs x TN nodes a thread block
with G warps a job, or a coarse_pass cluster of CLUSTER CTAs x THREADS
threads — is `csrc/<kernel>.cu` compiled with its `-D` overrides into
`_build/sweep/`, all compilers started together; the defaults are also
compiled with `-Xptxas -v`, whose register and spill report is printed.
Every variant is first held against the plain version on every kernel
case of `chip_smoke.py` and on the slices' busiest launch (identical
indices or assignments, bit-identical scores or availability), then
timed with `chip_smoke.cuda_ms`, cold (L2 evicted) and warm, on the cases
named in TIMED.  One JSON line per (variant, timed case), printed and,
with --out, written to a file.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys

from cook_tpu_torch import build

# kernel -> (-D prefix, launcher arg counts, -D names, variants); the
# first variant is the source's default
VARIANTS = {
    "best_node": ("BEST_NODE", (8, 3), ("TJ", "TN", "G"), [
        (32, 512, 1), (32, 1024, 2), (16, 1024, 2), (64, 1024, 2),
        (32, 1024, 1), (16, 512, 1), (64, 512, 1)]),
    "best_node_batched": ("BEST_NODE_BATCHED", (8, 4), ("TJ", "TN", "G"), [
        (8, 1024, 2), (16, 1024, 2), (4, 1024, 2), (8, 1024, 1),
        (16, 1024, 1)]),
    "coarse_pass": ("COARSE_PASS", (9, 6), ("CLUSTER", "THREADS"), [
        (8, 512), (1, 1024), (1, 512), (2, 1024), (4, 1024), (4, 512),
        (8, 1024), (8, 256), (16, 256), (16, 128)]),
}
# the timed cases: "slice launch", the launch of the slice's main path
# with the most live rows (the one chip_smoke.py times), labels of
# chip_smoke's KERNEL_CASES / BATCHED_CASES, and "slice-like", the
# hierarchical slice's fine launch as the scatter lays it out (the 4096
# live slots the first 2048 of two blocks)
TIMED = {
    "best_node": ("slice launch", "fleet 1024x16384 masked",
                  "mixed 1024x16384 masked", "dead", "empty mask"),
    "best_node_batched": ("slice launch", "slice-like",
                          "placed 16x2048x1024 masked",
                          "mixed 16x2048x1024 masked"),
    "coarse_pass": ("slice launch", "slice 4x4096x16", "mixed 16384x16",
                    "B 128 16384x128"),
}


def slice_like(smoke, dev):
    """[16, 2048, 1024] masked, live slots only in blocks 8 and 9."""
    from cook_tpu_torch.ops.common import BIG

    args = smoke.make_batched_inputs(16, 2048, 1024, "fleet", dev)
    demands = args[0].clone()
    demands[:8, :, 0] = 2 * BIG
    demands[10:, :, 0] = 2 * BIG
    return (demands, *args[1:])


def overheads(smoke, dev):
    """The flat slice's fleet launch with every job dead (the launch, the
    key scratch's memset and the finalize kernel alone), and with an empty
    mask (those plus every block staging its node tile)."""
    from cook_tpu_torch.ops.common import BIG

    args = smoke.make_inputs(1024, 16384, "fleet", dev)
    dead = args[0].clone()
    dead[:, 0] = 2 * BIG
    return {"dead": (dead, *args[1:]),
            "empty mask": (*args[:4], args[4] & False)}


def slice_launches(smoke):
    """{kernel: the arguments of its busiest launch on chip_smoke.py's
    flat and hierarchical slices}, replayed with the default tiles."""
    import tempfile

    from cook_tpu_torch.sim import cli

    with tempfile.TemporaryDirectory(prefix="cook-sweep-") as workdir:
        trace = os.path.join(workdir, "trace.json")
        cli.main(["synth", *smoke.SYNTH_ARGS, "--out", trace])
        _, flat = smoke.slice_phase(trace, workdir)
        _, hier = smoke.hier_slice_phase(trace)
    busy = {"best_node": smoke._unplaced,
            "best_node_batched": smoke._unplaced,
            "coarse_pass": smoke._coarse_live}
    calls = {"best_node": flat, **hier}
    # the latest of the busiest, as chip_smoke.launch_phase picks it
    return {name: max(reversed(calls[name]), key=active)
            for name, active in busy.items()}


def _tag(tile):
    return "x".join(map(str, tile))


def build_variants(names):
    """{(kernel, variant): ctypes.CDLL} for the kernels `names`; prints
    the defaults' ptxas report."""
    import ctypes

    out_dir = os.path.join(build.BUILD_DIR, "sweep")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in names:
        prefix, _, keys, tiles = VARIANTS[name]
        for tile in tiles:
            path = os.path.join(out_dir, f"lib{name}_{_tag(tile)}.so")
            defines = [f"-D{prefix}_{k}={v}" for k, v in zip(keys, tile)]
            verbose = ["-Xptxas", "-v"] if tile == tiles[0] else []
            procs[name, tile] = (path, subprocess.Popen(
                [build.nvcc(), *build.NVCC_FLAGS, *verbose, *defines,
                 "-o", path, os.path.join(build.CSRC_DIR, f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, failed = {}, []
    for (name, tile), (path, proc) in procs.items():
        text = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name} {tile}:\n{text}")
        else:
            if text.strip():
                print(f"== nvcc {name} {tile}\n{text.strip()}", flush=True)
            libs[name, tile] = ctypes.CDLL(path)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


@contextlib.contextmanager
def variant(name, lib):
    """The wrapper `ops.<name>.<name>` launching `lib` while the block
    runs."""
    _, counts, _, _ = VARIANTS[name]
    launch = build.bind(lib, name, *counts)
    original = build.launcher
    build.launcher = lambda *_: launch
    try:
        yield
    finally:
        build.launcher = original


def _line(card, case, ms, warm_ms, **variant):
    line = dict(**variant, case=case, card=card, ms=ms, warm_ms=warm_ms)
    print(json.dumps(line), flush=True)
    return line


def _holds(name, lib, case):
    """Whether the variant `lib` is swept on `case`: a coarse_pass cluster
    shape sets its CTA's warp partials and job slots, and is swept on a
    case only while they fit the card's shared memory (the wrapper sizes a
    paged launch's workspace for the default shape); tile variants take
    every case."""
    if name != "coarse_pass":
        return True
    import ctypes

    floats = lib.coarse_pass_workspace_floats
    floats.argtypes = [ctypes.c_int] * 3
    floats.restype = ctypes.c_longlong
    demands, block_avail, chunk = case[0], case[2], case[6]
    return floats(block_avail.shape[0], demands.shape[1], chunk) == 0


def sweep(smoke, name, libs, inputs, card):
    """Every variant of `name`: checked on every input, timed on
    TIMED[name]."""
    _, _, keys, tiles = VARIANTS[name]
    lines = []
    for tile in tiles:
        with variant(name, libs[name, tile]):
            held = {label: case for label, case in inputs.items()
                    if _holds(name, libs[name, tile], case)}
            for label in inputs.keys() - held.keys():
                print(f"{name} {tile}: {label} does not fit its shared "
                      "memory, skipped", flush=True)
            for label, case in held.items():
                smoke.check_identical(name, label, case)
            fn = getattr(smoke._module(name), name)
            for label in TIMED[name]:
                if label not in held:
                    continue
                case = inputs[label]
                lines.append(_line(
                    card, label, smoke.cuda_ms(lambda: fn(*case), cold=True),
                    smoke.cuda_ms(lambda: fn(*case)), kernel=name,
                    **{k.lower(): v for k, v in zip(keys, tile)}))
    return lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write the JSON lines here")
    parser.add_argument("--kernels", nargs="+", default=list(TIMED),
                        choices=list(TIMED), help="the kernels to sweep")
    args = parser.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as smoke

    dev = torch.device("cuda")
    card = smoke.device_phase()
    libs = build_variants(args.kernels)
    busiest = slice_launches(smoke)
    makers = {"best_node": (smoke.KERNEL_CASES, smoke.make_inputs),
              "best_node_batched": (smoke.BATCHED_CASES,
                                    smoke.make_batched_inputs)}
    lines = []
    for name in args.kernels:
        if name == "coarse_pass":
            inputs = {label: (*smoke.make_coarse_inputs(j, b, kind, dev),
                              chunk, passes, rounds)
                      for label, j, b, chunk, passes, rounds, kind
                      in smoke.COARSE_CASES}
        else:
            cases, make = makers[name]
            inputs = {label: make(*shape, kind, dev)
                      for label, *shape, kind in cases}
        inputs["slice launch"] = busiest[name]
        if name == "best_node_batched":
            inputs["slice-like"] = slice_like(smoke, dev)
        elif name == "best_node":
            inputs.update(overheads(smoke, dev))
        lines += sweep(smoke, name, libs, inputs, card)
        del inputs
    if args.out:
        with open(args.out, "w") as out:
            out.writelines(json.dumps(line) + "\n" for line in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
