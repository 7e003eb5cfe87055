"""Graph executor: an eager interpreter over the topological plan.

The torch counterpart of ``rten_tpu/runtime/executor.py`` (the reference's
interpreter loop, ``Graph::run_plan``, ``src/graph.rs:797-1073``). The JAX
package traces the whole plan into one jitted computation; the port runs
each op's torch lowering in plan order, so the card sees the ops' kernels
back to back and the host never waits for it between ops.

* Static values (constants and anything computed only from them or from
  shapes) stay numpy on the host, as the reference's static values do:
  ``Shape``/``Size`` produce numpy, and an op whose inputs are all static
  folds on the host (:mod:`.numpy_eval` where it has the op, else the torch
  lowering on CPU tensors, back to numpy). So Shape → Gather → Concat →
  Reshape chains never synchronize with the card.
* A constant that a device op reads moves to the executor's device once
  and stays there (``_const_device``, the reference's ``_device_const``).
* With ``RunOptions(timing=True)`` each op is timed with CUDA events on the
  card (the host clock on the CPU) into a :class:`RunTiming`; without it
  nothing synchronizes between ops.
* Capturing the whole plan as a CUDA graph is a later item (ROADMAP).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ir.graph import ConstantNode, Graph
from ..ops.common import to_tensor
from ..ops.numpy_eval import try_numpy_eval
from ..ops.registry import OpError, ensure_registered, get_op
from .timing import RunTiming, Timer


@dataclass
class RunOptions:
    """Analog of the reference ``RunOptions`` (``src/graph.rs:466-483``),
    with its fields: the port always runs eagerly (``eager`` changes
    nothing) and no ported op is random (``seed`` is unused)."""
    timing: bool = False
    timing_sort: str = "time"
    timing_by_shape: bool = False
    verbose: bool = False
    eager: bool = False
    seed: int = 0


class _Ctx:
    """Per-op lowering context handed to op functions (the ported ops read
    only their output count; the reference's context also carries the
    PRNG and subgraph runner of ops not ported yet)."""

    __slots__ = ("n_outputs",)

    def __init__(self, n_outputs):
        self.n_outputs = n_outputs


def is_static(v):
    return isinstance(v, (np.ndarray, np.generic))


def to_numpy(v):
    """A value (numpy or tensor) as a numpy array on the host."""
    if is_static(v):
        return np.asarray(v)
    return v.detach().cpu().numpy()


def _tree(fn, result):
    if isinstance(result, tuple):
        return tuple(fn(r) for r in result)
    return fn(result)


class GraphExecutor:
    def __init__(self, graph: Graph, device="cuda"):
        ensure_registered()
        self.graph = graph
        self.device = resolve_device(device)
        self._const_device: dict = {}   # node_id -> device-resident tensor
        self.last_timing: Optional[RunTiming] = None

    def _device_value(self, graph, value_id, value):
        """A non-static operand as a tensor on the device; a graph constant
        is moved once and cached."""
        if not is_static(value):
            return value
        node = graph.nodes[value_id].data if value_id is not None else None
        if graph is self.graph and isinstance(node, ConstantNode) \
                and node.array is value:
            cached = self._const_device.get(value_id)
            if cached is None:
                cached = to_tensor(value, self.device)
                self._const_device[value_id] = cached
            return cached
        return to_tensor(value, self.device)

    def _eval_plan(self, graph: Graph, env: dict, plan, *,
                   timing: Optional[list] = None, verbose=False):
        """Evaluate operator nodes of ``plan`` over ``env`` (node id →
        value). Static numpy values propagate through ops whose inputs are
        all static; device tensors produce device tensors. ``timing``: a
        list that receives (op type, input shapes, seconds or a pair of
        CUDA events) per op."""
        cuda_events = self.device.type == "cuda"
        for op_id in plan:
            node = graph.nodes[op_id]
            op = node.data
            spec = get_op(op.op_type)
            args = [env.get(i) if i is not None else None for i in op.inputs]
            ctx = _Ctx(len(op.outputs))

            required = [a for a in args if a is not None]
            all_static = all(is_static(a) for a in required)
            if spec.data_dependent:
                args = [None if a is None else to_numpy(a) for a in args]
            else:
                for i in spec.static:
                    if i < len(args) and args[i] is not None \
                            and not is_static(args[i]):
                        args[i] = to_numpy(args[i])
            fold = all_static and not spec.random
            shapes = tuple(tuple(a.shape) for a in required)

            t0 = time.perf_counter()
            on_card = False
            if spec.data_dependent:
                result = spec.fn(ctx, op.attrs, *args)
            elif fold:
                # Host path: numpy where the table has the op, else the
                # torch lowering on CPU tensors, back to numpy.
                handled, result = try_numpy_eval(op.op_type, op.attrs, args)
                if not handled:
                    result = spec.fn(ctx, op.attrs, *[
                        a if a is None or i in spec.static
                        else to_tensor(a, "cpu") for i, a in enumerate(args)])
                    result = _tree(to_numpy, result)
            else:
                args = [a if a is None or i in spec.static
                        else self._device_value(graph, op.inputs[i], a)
                        for i, a in enumerate(args)]
                on_card = cuda_events and timing is not None
                if on_card:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                result = spec.fn(ctx, op.attrs, *args)
                if on_card:
                    end.record()
            if timing is not None:
                timing.append((op.op_type, shapes, (start, end) if on_card
                               else time.perf_counter() - t0))
            if verbose:
                print(f"[{op_id}] {op.op_type} {node.name or ''} "
                      f"inputs={list(shapes)}")

            if not isinstance(result, tuple):
                result = (result,)
            if len(result) < len(op.outputs):
                raise OpError(op.op_type,
                              f"produced {len(result)} outputs, "
                              f"expected {len(op.outputs)}")
            for out_id, value in zip(op.outputs, result):
                if out_id is not None:
                    env[out_id] = value
        return env

    def _env(self, inputs):
        env = dict(inputs)
        for i, n in enumerate(self.graph.nodes):
            if isinstance(n.data, ConstantNode):
                env[i] = n.data.array
        return env

    def run(self, inputs: dict, output_ids=None,
            options: Optional[RunOptions] = None):
        """Run the plan from ``inputs`` (node id → numpy array or tensor;
        moved to the device, where they are device values as the
        reference's traced inputs are) to ``output_ids``. Returns tensors on
        the device."""
        options = options or RunOptions()
        graph = self.graph
        output_ids = (list(output_ids) if output_ids is not None
                      else graph.outputs)
        env = self._env({k: to_tensor(v, self.device)
                         for k, v in inputs.items()})
        plan = graph.plan(list(inputs.keys()), output_ids)
        records = [] if options.timing else None
        with Timer() as t:
            self._eval_plan(graph, env, plan, timing=records,
                            verbose=options.verbose)
            if records is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        if records is not None:
            timing = RunTiming(total=t.elapsed)
            for name, shapes, dt in records:
                if isinstance(dt, tuple):
                    dt = dt[0].elapsed_time(dt[1]) / 1e3
                timing.add(name, dt, shapes)
            self.last_timing = timing
            print(timing.summary(options.timing_sort, options.timing_by_shape))
        return [self._device_value(graph, o, env[o]) for o in output_ids]

    # ------------------------------------------------------------------
    # Partial evaluation
    # ------------------------------------------------------------------

    def partial_run(self, inputs: dict, output_ids=None):
        """Evaluate every op whose transitive deps are available from
        ``inputs`` + constants; returns {node_id: value} for the deepest
        computed values on the paths to ``output_ids`` (the reference's
        ``Graph::partial_run``, ``src/graph.rs:1147-1234``). Numpy inputs
        stay static, as in the reference."""
        graph = self.graph
        output_ids = list(output_ids) if output_ids is not None else graph.outputs
        env = self._env(inputs)

        resolved: dict[int, bool] = {}

        def computable(value_id) -> bool:
            if value_id in env:
                return True
            if value_id in resolved:
                return resolved[value_id]
            op_id = graph.producer_of(value_id)
            if op_id is None:
                resolved[value_id] = False
                return False
            op = graph.nodes[op_id].data
            # Nondeterministic ops must not be pre-evaluated (the reference
            # gates constant propagation on Operator::is_deterministic).
            if get_op(op.op_type).random:
                resolved[value_id] = False
                return False
            ok = all(computable(i) for i in op.inputs if i is not None)
            for out in op.outputs:
                if out is not None:
                    resolved[out] = ok
            return resolved.get(value_id, False)

        # Frontier: deepest computable values feeding each output.
        frontier: set[int] = set()
        seen: set[int] = set()

        def walk(value_id):
            if value_id in seen:
                return
            seen.add(value_id)
            if computable(value_id):
                frontier.add(value_id)
                return
            op_id = graph.producer_of(value_id)
            if op_id is None:
                return
            for i in graph.nodes[op_id].data.inputs:
                if i is not None:
                    walk(i)

        for o in output_ids:
            walk(o)

        target = [f for f in frontier if f not in env]
        if target:
            plan = graph.plan(list(env.keys()), target)
            self._eval_plan(graph, env, plan)
        return {f: env[f] for f in frontier}
