"""Multi-pod dry run: one rank's program of every (arch × shape × mesh)
cell, counted on ``meta`` tensors over a fake process group.

Counterpart of ``repro.launch.dryrun``.  The reference lowers and
compiles each cell for 512 placeholder TPU devices and reads XLA's
memory and cost analyses and HLO text.  Here each cell is one call of the
port's own step function (``make_train_step``, ``make_prefill_step`` or
``make_decode_step``) on rank 0 of a mesh of the cell's size: the state
from ``abstract_train_state`` and the batch from ``input_specs``, both
``meta`` tensors, placed as DTensors by ``steps.train_state_shardings``'s
rules (``sharding.tree_shardings``), each rank's block a ``meta`` tensor
of its local shape.  The process group is ``torch.testing``'s fake one
(``launch.mesh.init_fake_world``): collectives return at once.  The
census (``roofline.census``) counts the rank's ops, collectives and live
bytes, and ``roofline.model`` prices them at the H100's rates.  Nothing
runs on a card: like the reference's placeholder devices, the dry run
needs none.

The result dict has the reference's keys:

* ``memory.argument_bytes``: the rank's bytes of state plus batch (its
  local blocks; a decode's position ``idx`` counts as the int32 scalar
  of ``input_specs``);
* ``memory.output_bytes``: the bytes of the step's outputs (a train
  step returns the state it was given, updated in place);
* ``memory.temp_bytes``: the census's peak of live bytes less the
  arguments';
* ``cost_analysis.flops``: the census's ``dot_flops``;
  ``cost_analysis.bytes_accessed``: its traffic;
* ``hlo``: the census's stats (``CensusStats``'s fields, ``ops`` as
  ``[calls, flops, bytes]`` an op name);
* ``roofline``: ``roofline()`` with ``model_flops_for``;
* ``lower_s``: the census's wall time on the host;
* keys with no counterpart on the card are ``None``:
  ``memory.generated_code_bytes``, ``memory.alias_bytes``,
  ``cost_analysis.transcendentals``, ``hlo.while_trip_counts``,
  ``hlo.hlo_chars`` and ``compile_s``.

A decode step reads its position on the host (``int(idx)``); a ``meta``
scalar has no value, so the dry run passes the last position,
``seq_len - 1``, as an int: the step attends over the whole cache with
a mask whatever the position, so the count does not depend on it.

One process holds one fake process group, of one size: ``--all`` runs
each mesh kind's cells in a child process of its own.  Usage:

  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      --arch phi3-mini-3.8b --shape train_4k --mesh single   # prints JSON
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out DIR
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import traceback

import torch

from repro_torch import optim
from repro_torch import sharding
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.mesh import (init_fake_world, make_production_mesh,
                                     make_test_mesh)
from repro_torch.models import (SHAPES, abstract_train_state, input_specs,
                                make_decode_step, make_prefill_step,
                                make_train_step, shape_applicable)
from repro_torch.roofline import census
from repro_torch.roofline.model import model_flops_for, roofline

BIG_ARCHS = {"deepseek-v3-671b", "command-r-plus-104b", "yi-34b",
             "chameleon-34b"}

# mesh kind → (shape, multi_pod, production)
MESHES = {"single": ((16, 16), False, True),
          "multi": ((2, 16, 16), True, True),
          "test-single": ((4, 2), False, False),
          "test-multi": ((2, 2, 2), True, False)}


def opt_config_for(arch: str) -> optim.OptConfig:
    if arch == "deepseek-v3-671b":
        return optim.OptConfig(kind="adafactor")
    if arch in BIG_ARCHS:
        return optim.OptConfig(kind="adamw", moment_dtype="bfloat16")
    return optim.OptConfig(kind="adamw")


def rules_for(arch: str, shape: str):
    over = {}
    if shape in ("prefill_32k",):
        over["seq"] = "model"          # SP for long prefill activations
    if arch in BIG_ARCHS:
        over["embed_fsdp"] = "data"
    if SHAPES[shape].kind == "decode":
        over["kv_seq"] = "model"       # sequence-sharded KV caches
    return sharding.with_rules(over)


def build_mesh(mesh_kind: str):
    """The mesh of ``mesh_kind`` over a fake process group of its size,
    this process its rank 0.  The mesh's device type is "cuda", the
    card's, so that DTensor redistributes as it would there (on a "cpu"
    mesh it takes an all-to-all for an all-gather and a chunk); its
    tensors stay on ``meta``, and no card is needed or touched."""
    if mesh_kind not in MESHES:
        raise ValueError(mesh_kind)
    shape, multi_pod, production = MESHES[mesh_kind]
    n = 1
    for s in shape:
        n *= s
    init_fake_world(n)
    if production:
        return make_production_mesh(multi_pod=multi_pod, device_type="cuda")
    return make_test_mesh(multi_pod=multi_pod, device_type="cuda")


def place_abstract(tree, shardings):
    """Every ``meta`` leaf of ``tree`` as a DTensor placed by
    ``shardings`` (``(mesh, placements)`` leaves), its local block a
    ``meta`` tensor of the rank's shape.  ``shardings`` None: the tree."""
    if shardings is None:
        return tree
    if isinstance(tree, dict):
        return {k: place_abstract(v, shardings[k]) for k, v in tree.items()}
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh, placements = shardings
    local, _ = compute_local_shape_and_global_offset(
        tuple(tree.shape), mesh, placements)
    block = torch.empty(local, dtype=tree.dtype, device="meta")
    return DTensor.from_local(block, mesh, tuple(placements),
                              run_check=False, shape=tree.shape,
                              stride=tree.stride())


def local_bytes(tree) -> int:
    """The bytes of this rank's blocks of every tensor leaf of ``tree``."""
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(local_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return census.tensor_bytes(sharding.local(tree))
    return 0


def cell_args(cfg, arch: str, shape: str, mesh, rules):
    """(step, args, argument bytes) of one cell: the step function and
    its abstract state and batch, placed on ``mesh`` (None: one device,
    plain ``meta`` tensors)."""
    s = SHAPES[shape]
    opt_cfg = opt_config_for(arch)

    def sh(logical, tree):
        return None if mesh is None else sharding.tree_shardings(
            logical, mesh, rules, shape_tree=tree)

    batch, batch_logical = input_specs(cfg, shape)
    batch = place_abstract(batch, sh(batch_logical, batch))
    params, pspecs, opt_state, ospecs = abstract_train_state(cfg, opt_cfg)
    params = place_abstract(params, sh(pspecs, params))
    if s.kind == "train":
        opt_state = place_abstract(opt_state, sh(ospecs, opt_state))
        args = (params, opt_state, batch)
        step = make_train_step(cfg, opt_cfg)
    elif s.kind == "prefill":
        args = (params, batch)
        step = make_prefill_step(cfg, total_len=s.seq_len)
    else:
        args = (params, batch)
        step = make_decode_step(cfg)
    arg_bytes = local_bytes(args)
    if s.kind == "decode":
        batch["idx"] = s.seq_len - 1     # read on the host by the step
    return step, args, arg_bytes


def lower_cell(arch: str, shape: str, mesh_kind: str,
               include_hlo_stats: bool = True):
    """Count one cell; returns a JSON-able result dict."""
    cfg = get_config(arch)
    if not shape_applicable(cfg, shape):
        return {"arch": arch, "shape": shape, "mesh": mesh_kind,
                "status": "skipped",
                "reason": "full-attention arch: 500k dense KV cache is the "
                          "quadratic regime this shape excludes"}
    mesh = build_mesh(mesh_kind)
    rules = rules_for(arch, shape)
    s = SHAPES[shape]
    n_dev = 1 if mesh is None else mesh.size()

    with sharding.use_mesh(mesh, rules):
        step, args, arg_bytes = cell_args(cfg, arch, shape, mesh, rules)
        outputs = []

        def run(*a):
            out = step(*a)
            outputs.append(local_bytes(out))
            return out
        stats = census.analyze(run, *args)
    del args

    result = {
        "arch": arch, "shape": shape, "mesh": mesh_kind, "status": "ok",
        "chips": n_dev,
        "lower_s": round(stats.wall_s, 1), "compile_s": None,
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": outputs[0],
            "temp_bytes": stats.peak_bytes - stats.argument_bytes,
            "generated_code_bytes": None,
            "alias_bytes": None,
        },
        "cost_analysis": {
            "flops": stats.dot_flops,
            "bytes_accessed": stats.traffic_bytes,
            "transcendentals": None,
        },
    }
    if include_hlo_stats:
        result["hlo"] = {
            "collective_bytes": stats.collective_bytes,
            "collective_bytes_by_kind": stats.collective_bytes_by_kind,
            "collective_count": stats.collective_count,
            "dot_flops": stats.dot_flops,
            "traffic_bytes": stats.traffic_bytes,
            "traffic_bytes_fused": stats.traffic_bytes_fused,
            "while_trip_counts": stats.while_trip_counts,
            "hlo_chars": None,
            "peak_bytes": stats.peak_bytes,
            "ops": {name: [t.calls, t.flops, t.bytes]
                    for name, t in stats.ops.items()},
        }
        mf = model_flops_for(cfg, s.kind, s.seq_len, s.global_batch)
        rl = roofline(stats.dot_flops, stats.traffic_bytes_fused,
                      stats.collective_bytes, n_dev, mf)
        rl_raw = roofline(stats.dot_flops, stats.traffic_bytes,
                          stats.collective_bytes, n_dev, mf)
        result["roofline"] = {
            "compute_s": rl.compute_s, "memory_s": rl.memory_s,
            "memory_s_raw": rl_raw.memory_s,
            "collective_s": rl.collective_s, "bottleneck": rl.bottleneck,
            "step_time_s": rl.step_time_s, "mfu": rl.mfu,
            "mfu_raw": rl_raw.mfu,
            "model_flops": mf, "flops_global": rl.flops_global,
            "useful_ratio": rl.useful_ratio,
        }
    gc.collect()
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", default=None, choices=list(MESHES),
                    help="default: single (with --all: single and multi)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None, help="directory for JSON results")
    ap.add_argument("--no-hlo", action="store_true")
    args = ap.parse_args(argv)

    if args.all and args.mesh is None:
        # one fake process group a process: a child a mesh kind
        rc = 0
        for kind in ("single", "multi"):
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--all", "--mesh", kind]
            cmd += ["--out", args.out] if args.out else []
            cmd += ["--no-hlo"] if args.no_hlo else []
            rc = max(rc, subprocess.run(cmd).returncode)
        return rc
    mesh_kind = args.mesh or "single"
    if args.all:
        cells = [(arch, shape, mesh_kind) for arch in ARCH_IDS
                 for shape in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        cells = [(args.arch, args.shape, mesh_kind)]

    for arch, shape, kind in cells:
        tag = f"{arch}__{shape}__{kind}"
        try:
            res = lower_cell(arch, shape, kind,
                             include_hlo_stats=not args.no_hlo)
        except Exception as e:  # noqa: BLE001 — report, don't die mid-sweep
            res = {"arch": arch, "shape": shape, "mesh": kind,
                   "status": "error", "error": repr(e),
                   "trace": traceback.format_exc()[-4000:]}
        js = json.dumps(res, indent=1, default=float)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                f.write(js)
            print(tag, res["status"], flush=True)
        else:
            print(js, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
