"""Public Model API: load `.rten` files, run inference.

The torch counterpart of ``rten_tpu/runtime/model.py`` (the reference's
``Model``, ``src/model.rs:209-647``) with the same surface — ``load_file``
/ ``load`` / ``run`` / ``run_one`` / ``partial_run`` / ``node_id`` /
``input_ids`` / ``output_ids`` / ``metadata`` — on the port's eager
executor. ``ModelOptions.device`` (or ``device=`` to ``load`` /
``load_file``) places the model: "cuda" by default, which raises without a
card; ``"cpu"`` runs the plain versions of the kernels. Outputs are
tensors on that device.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

from ..device import resolve_device

from ..fmt import container
from ..ir import optimize as opt
from ..ir.graph import Graph, ValueNode, graph_from_model_file
from .executor import GraphExecutor, RunOptions


class RunError(RuntimeError):
    """Model execution error (reference ``RunError``, src/graph.rs:248)."""


@dataclass
class ModelMetadata:
    onnx_hash: Optional[str] = None
    description: Optional[str] = None
    license: Optional[str] = None
    commit: Optional[str] = None
    code_repository: Optional[str] = None
    model_repository: Optional[str] = None
    run_id: Optional[str] = None
    run_url: Optional[str] = None


@dataclass
class ModelOptions:
    """Load options (reference ``ModelOptions``, ``src/model.rs:155-207``)."""
    optimize: bool = True
    use_mmap: bool = True
    native: bool = True    # use the C++ container reader when built
    device: str = "cuda"


def _options(options, device):
    """The load options, with ``device`` (when given) replacing theirs; the
    device is resolved first, so asking for the card without one raises
    before any parsing."""
    options = options or ModelOptions()
    if device is not None:
        options = replace(options, device=device)
    resolve_device(options.device)
    return options


class Model:
    def __init__(self, graph: Graph, metadata: Optional[ModelMetadata] = None,
                 device="cuda"):
        self.graph = graph
        self.metadata = metadata or ModelMetadata()
        self.executor = GraphExecutor(graph, device)

    @property
    def device(self):
        return self.executor.device

    # -- loading -----------------------------------------------------------

    @staticmethod
    def load_file(path, options: Optional[ModelOptions] = None,
                  device=None) -> "Model":
        options = _options(options, device)
        mf = container.load_file(path, use_mmap=options.use_mmap)
        return Model._from_model_file(mf, options)

    @staticmethod
    def load(data: bytes, options: Optional[ModelOptions] = None,
             device=None) -> "Model":
        options = _options(options, device)
        mf = container.load_bytes(data)
        return Model._from_model_file(mf, options)

    # Reference parity alias: mmap is the default load path here.
    load_mmap = load_file

    @staticmethod
    def _from_model_file(mf, options: ModelOptions) -> "Model":
        graph = None
        md = None
        from ..utils.env import env_flag
        if options.native and not env_flag("RTEN_TPU_NO_NATIVE"):
            try:
                from ..fmt import native_loader
                if native_loader.available(auto_build=False):
                    parsed = native_loader.read_model_json(mf.buf)
                    graph = native_loader.graph_from_native(mf.buf, parsed)
                    md = parsed.get("metadata")
            except Exception:
                graph = None   # fall back to the Python reader
        if graph is None:
            graph = graph_from_model_file(mf)
            md = mf.model.get("metadata")
        if options.optimize:
            opt.optimize(graph)
        meta = ModelMetadata()
        if md:
            for key in vars(meta):
                if md.get(key) is not None:
                    setattr(meta, key, md[key])
        return Model(graph, meta, options.device)

    # -- introspection -----------------------------------------------------

    def input_ids(self):
        return list(self.graph.inputs)

    def output_ids(self):
        return list(self.graph.outputs)

    def input_names(self):
        return self.graph.input_names()

    def output_names(self):
        return self.graph.output_names()

    def node_id(self, name: str) -> Optional[int]:
        return self.graph.node_id(name)

    def input_shape(self, node_id) -> Optional[list]:
        node = self.graph.nodes[node_id]
        if isinstance(node.data, ValueNode):
            return node.data.shape
        return None

    def num_params(self) -> int:
        return self.graph.num_params()

    # -- running -----------------------------------------------------------

    def _resolve_inputs(self, inputs: dict) -> dict:
        resolved = {}
        for key, value in inputs.items():
            if isinstance(key, str):
                node_id = self.graph.node_id(key)
                if node_id is None:
                    raise KeyError(f"no node named {key!r}")
                key = node_id
            resolved[key] = value
        return resolved

    def _resolve_outputs(self, outputs):
        if outputs is None:
            return None
        out = []
        for o in outputs:
            if isinstance(o, str):
                node_id = self.graph.node_id(o)
                if node_id is None:
                    raise KeyError(f"no node named {o!r}")
                o = node_id
            out.append(o)
        return out

    def run(self, inputs: dict, outputs=None,
            options: Optional[RunOptions] = None) -> list:
        """Run the model. ``inputs``: {name-or-id: numpy array or tensor};
        ``outputs``: names/ids (default: graph outputs). Returns tensors on
        the model's device. Honors the RTEN_TPU_TIMING / RTEN_TPU_EAGER env
        knobs (the reference reads RTEN_TIMING here too,
        src/model.rs:587)."""
        from ..utils.env import timing_options_from_env
        options = timing_options_from_env(options)
        resolved = self._resolve_inputs(inputs)
        missing = [self.graph.nodes[i].name or str(i)
                   for i in self.graph.inputs if i not in resolved]
        if missing:
            raise RunError(f"missing model inputs: {missing} "
                           f"(expected {self.input_names()})")
        return self.executor.run(resolved,
                                 self._resolve_outputs(outputs), options)

    def run_one(self, input_array, options: Optional[RunOptions] = None):
        """Single-input single-output sugar (reference ``Model::run_one``)."""
        (input_id,) = self.graph.inputs
        outs = self.run({input_id: input_array}, None, options)
        return outs[0]

    def partial_run(self, inputs: dict, outputs=None) -> dict:
        resolved = self.executor.partial_run(
            self._resolve_inputs(inputs), self._resolve_outputs(outputs))
        return resolved
