"""CLI: inspect `.rten` models and smoke-run them with auto-generated
inputs, on the card or the CPU.

The torch counterpart of ``rten_tpu/cli.py`` (the reference's rten-cli,
``rten-cli/src/main.rs``): same flags — model info
(params/metadata/inputs/outputs), run with random inputs, resolve symbolic
dims via ``--size name=N``, ``--timing``, ``-v``, ``-n iters``, ``--eager``
— with ``--device`` (``cuda`` by default, which raises without a card;
``cpu``) in place of ``--platform``::

    python -m rten_tpu_torch.cli model.rten [--timing] [-n N] [--device cpu]

Input synthesis mirrors the reference's name heuristics
(``rten-cli/src/main.rs:249-267``): ``*_mask`` → ones, ``*_ids``/
``*indices`` → zeros, everything else uniform f32.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def synthesize_input(name, shape, dim_sizes):
    resolved = []
    for d in shape or []:
        if isinstance(d, str):
            resolved.append(dim_sizes.get(d, 1))
        else:
            resolved.append(int(d) if d > 0 else 1)
    name = name or ""
    if name.endswith("_mask"):
        return np.ones(resolved, dtype=np.float32)
    if name.endswith("_ids") or "indices" in name:
        return np.zeros(resolved, dtype=np.int32)
    rng = np.random.RandomState(1234)
    return rng.uniform(0, 1, resolved).astype(np.float32)


def cmd_run(args):
    from .runtime.model import Model, ModelOptions
    from .runtime.executor import RunOptions

    t0 = time.perf_counter()
    model = Model.load_file(args.model,
                            ModelOptions(optimize=not args.no_optimize,
                                         use_mmap=args.mmap,
                                         device=args.device))
    load_s = time.perf_counter() - t0
    sync = (torch.cuda.synchronize if model.device.type == "cuda"
            else (lambda: None))

    meta = model.metadata
    print(f"Model: {args.model} on {model.device}")
    print(f"  Parameters: {model.num_params():,}")
    print(f"  Load time: {load_s*1e3:.1f} ms")
    for key, value in vars(meta).items():
        if value:
            print(f"  {key}: {value}")
    dim_sizes = {}
    for spec in args.size or []:
        name, _, value = spec.partition("=")
        dim_sizes[name] = int(value)

    print("  Inputs:")
    inputs = {}
    for node_id in model.input_ids():
        name = model.graph.nodes[node_id].name
        shape = model.input_shape(node_id)
        arr = synthesize_input(name, shape, dim_sizes)
        inputs[node_id] = arr
        print(f"    {name}: declared {shape} -> synthesized "
              f"{list(arr.shape)} {arr.dtype}")
    print("  Outputs:")
    for node_id in model.output_ids():
        print(f"    {model.graph.nodes[node_id].name}")

    if args.inspect:
        ops = {}
        from .ir.graph import OperatorNode
        for node in model.graph.nodes:
            if isinstance(node.data, OperatorNode):
                ops[node.data.op_type] = ops.get(node.data.op_type, 0) + 1
        print("  Operators:")
        for op_type, count in sorted(ops.items(), key=lambda kv: -kv[1]):
            print(f"    {op_type:<24} {count}")
        return 0

    options = RunOptions(timing=args.timing, verbose=args.verbose,
                         eager=args.eager)
    # Warmup run (the kernels' first launches), then timed iterations.
    outputs = model.run(inputs, options=options)
    sync()
    warmup_s = time.perf_counter() - t0 - load_s
    times = []
    for _ in range(args.n_iters):
        t1 = time.perf_counter()
        outputs = model.run(inputs, options=options)
        sync()
        times.append(time.perf_counter() - t1)
    print(f"  Warmup: {warmup_s*1e3:.1f} ms")
    if times:
        print(f"  Run time over {len(times)} iters: "
              f"mean {np.mean(times)*1e3:.2f} ms, "
              f"min {np.min(times)*1e3:.2f} ms, "
              f"max {np.max(times)*1e3:.2f} ms")
    for node_id, out in zip(model.output_ids(), outputs):
        name = model.graph.nodes[node_id].name
        arr = out.cpu().numpy()
        print(f"  Output {name}: shape {list(arr.shape)} dtype {arr.dtype}")
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="rten_tpu_torch.cli",
        description="Inspect and run .rten models on the card (or CPU).")
    parser.add_argument("model", help="path to .rten model")
    parser.add_argument("--inspect", action="store_true",
                        help="print model info without running")
    parser.add_argument("--size", action="append", metavar="name=N",
                        help="size for a symbolic input dim (repeatable)")
    parser.add_argument("-n", "--n-iters", type=int, default=1,
                        help="timed iterations after warmup")
    parser.add_argument("--timing", action="store_true",
                        help="per-op timing table (CUDA events on the card)")
    parser.add_argument("-v", "--verbose", action="store_true")
    parser.add_argument("--eager", action="store_true",
                        help="eager execution (the port always runs eagerly)")
    parser.add_argument("--no-optimize", action="store_true",
                        help="skip load-time graph optimization")
    parser.add_argument("--no-mmap", dest="mmap", action="store_false",
                        help="read the whole file instead of mmap")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args(argv)
    return cmd_run(args)


if __name__ == "__main__":
    sys.exit(main())
