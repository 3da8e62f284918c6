r"""The compiled step: a step function captured into CUDA graphs.

The JAX package compiles each step with ``jax.jit`` (the builders'
``use_jit``) and then runs it as one program. The port's counterpart is
CUDA-graph capture with ``torch.cuda.CUDAGraph``: :class:`CompiledStep`
wraps a step function ``fn(*args)``, and on CUDA tensors

- the first call of each signature (the shapes and dtypes of the tensor
  arguments, the identity of the other objects among them) runs eagerly, on
  a side stream: it is a real step, and it warms what runs once (cuDNN's
  plans, Triton's JIT, the kernels' ``nvcc`` build), as JAX's first call
  compiles and runs;
- the second captures the step into a graph and replays it: a capture
  executes nothing, so that replay is the real second step; every later
  call of the signature replays, one launch from the host per step;
- each call's tensors are copied into the graph's static inputs, and each
  float argument into a static 0-d f32 tensor on the card, filled before
  every replay: a value the host computes for each step (PhyDNet's
  teacher-forcing ratio, PredRNN++'s sampling rates) reaches the replays,
  where a float captured into the graph would stay what it was at the
  capture;
- the outputs are clones of the static outputs, so that a caller that
  keeps them keeps its own values, as JAX returns new arrays;
- every ``torch.Generator`` among the arguments is registered with the
  graph, so that each replay draws fresh numbers, those the eager step
  would draw;
- all of one wrapper's graphs share one memory pool;
- a capture that fails raises: a step never carries on eagerly on the card.

On CPU tensors every call runs ``fn`` eagerly (the floats as 0-d f32
tensors all the same): the plain path, as the kernel wrappers compute their
plain versions on the CPU.

What the host does for each step (Python counters, schedules) stays outside
``fn``: a replay runs none of it. The kernel wrappers' ``launches`` counters
count Python calls, so the eager call and the capture move them and a
replay does not.
"""
import torch
from torch.utils import _pytree as pytree


def _signature(leaves):
    r"""The graph key of one call's flattened arguments."""
    key = []
    for x in leaves:
        if torch.is_tensor(x):
            key.append(("tensor", tuple(x.shape), x.dtype, x.device))
        elif isinstance(x, float):
            key.append(("float",))
        elif x is None or isinstance(x, (bool, int, str)):
            key.append(("constant", x))
        else:
            key.append(("object", id(x)))
    return tuple(key)


def _call(fn, leaves, spec, device):
    r"""``fn`` on the arguments ``leaves``, each float as a 0-d f32 tensor
    on ``device``."""
    return fn(*pytree.tree_unflatten(
        [torch.full((), x, dtype=torch.float32, device=device) if isinstance(x, float) else x
         for x in leaves], spec))


class _Graph:
    r"""One captured signature: the graph, its static inputs and outputs,
    and the objects whose identity its key holds (kept alive, so that their
    ids are not reused)."""

    def __init__(self, graph, statics, outputs, pinned):
        self.graph, self.statics, self.pinned = graph, statics, pinned
        self.outputs, self.out_spec = pytree.tree_flatten(outputs)

    def replay(self, leaves):
        for static, x in zip(self.statics, leaves):
            if torch.is_tensor(x):
                static.copy_(x)
            elif isinstance(x, float):
                static.fill_(x)
        self.graph.replay()
        return pytree.tree_unflatten([t.clone() if torch.is_tensor(t) else t
                                      for t in self.outputs], self.out_spec)


class CompiledStep:
    r"""``fn`` as a step (module docstring): behind CUDA-graph capture with
    ``use_jit`` on CUDA tensors, else run eagerly on every call. ``name``
    names the step in errors."""

    def __init__(self, fn, name, use_jit=True):
        self.fn, self.name, self.use_jit = fn, name, use_jit
        self.graphs = {}      # key -> _Graph
        self.warm = {}        # key -> the objects of its first, eager call
        self.pool = None      # the memory pool of all of this step's graphs
        self.stream = None    # the side stream of the eager first calls

    def __call__(self, *args):
        leaves, spec = pytree.tree_flatten(args)
        devices = {x.device for x in leaves if torch.is_tensor(x)}
        device = next(iter(devices), torch.device("cpu"))
        if not self.use_jit or all(d.type != "cuda" for d in devices):
            return _call(self.fn, leaves, spec, device)
        if len(devices) > 1:
            raise ValueError(f"{self.name}: every tensor argument of a compiled step must lie on "
                             f"one card, got {sorted(map(str, devices))}")
        key = (spec, _signature(leaves))
        graph = self.graphs.get(key)
        if graph is None:
            pinned = [x for x in leaves if not torch.is_tensor(x) and not isinstance(x, float)]
            if key not in self.warm:
                self.warm[key] = pinned
                return self._eager(leaves, spec, device)
            graph = self.graphs[key] = self._capture(leaves, spec, device, pinned)
            del self.warm[key]
        return graph.replay(leaves)

    def _eager(self, leaves, spec, device):
        r"""The first call of a signature, on a side stream, as
        ``torch.cuda.make_graphed_callables`` warms up."""
        if self.stream is None:
            self.stream = torch.cuda.Stream(device)
        current = torch.cuda.current_stream(device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = _call(self.fn, leaves, spec, device)
        current.wait_stream(self.stream)
        return out

    def _capture(self, leaves, spec, device, pinned):
        statics = [x.detach().clone() if torch.is_tensor(x) else
                   torch.full((), x, dtype=torch.float32, device=device) if isinstance(x, float)
                   else x for x in leaves]
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(device):
            for generator in {id(x): x for x in leaves if isinstance(x, torch.Generator)}.values():
                graph.register_generator_state(generator)
            try:
                with torch.cuda.graph(graph, pool=self.pool):
                    outputs = self.fn(*pytree.tree_unflatten(statics, spec))
            except Exception as e:
                e.add_note(f"while capturing {self.name} into a CUDA graph (use_jit=True); "
                           f"build it with use_jit=False to run it eagerly")
                raise
        return _Graph(graph, statics, outputs, pinned)
