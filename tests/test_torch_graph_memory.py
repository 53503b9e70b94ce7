"""What a captured solve holds in device memory (``enlsip_tpu_torch/_graph.py``).

Every conditional body of a capture, at every depth, is captured on ONE
body stream (``csrc/graph_cond.cu`` suspends the enclosing body's capture
while a nested one is captured, and resumes it after the new node), so
that PyTorch's caching allocator, which reuses a freed block only on the
stream it was freed on, reuses one body's blocks in the next.

On the CPU: the capture protocol of ``_graph._body`` against a model of
CUDA's stream capture (a stream captures into one graph at a time; a
nested body suspends its parent's capture and its end resumes it after
the node; the root body forks from PyTorch's capture stream), and the
release of the eager warm-up's tensors before a solve's rehearsal
(weak references).  On the card (``gpu``): a captured Chained Rosenbrock
n=200 and a giant-m solve at 200,000 rows, float64, dense Jacobian (c),
each held to the targets against its eager loop (the capturing call's
peak within 1.5x the eager peak, the memory the cached graph holds
within 1.25x the eager peak plus the static inputs) and to the eager
loop's bits; and reverse-mode AD captured in a body, replayed after the
default pool's cache went back to the card, equal to its eager values
(every block the capture allocates, on any thread, is the graph's).
No JAX here."""

import contextlib
import weakref

import pytest
import torch
from torch.utils import _pytree as pytree

import enlsip_tpu_torch as et
from enlsip_tpu_torch import _graph, _lanes
from enlsip_tpu_torch.core import driver as tdrv
from enlsip_tpu_torch.core.subproblem import hessian_contractions
from enlsip_tpu_torch.models.model import _model_functions, _solve_functions
from enlsip_tpu_torch.problems import _const
from enlsip_tpu_torch.problems.classic import HS65, chained_rosenbrock

F64 = torch.float64

# A JAX-free file: pin torch to one thread a worker as the other port
# files do (torch_port_helpers)
torch.set_num_threads(1)


# ------------------------------------------------ the capture protocol


class _Stream:
    def __init__(self, name):
        self.name = name
        self.cuda_stream = id(self)
        self.device = torch.device("cpu")


class _FakeCapture:
    """CUDA's stream capture as ``graph_cond.cu`` drives it: a stream
    captures into at most one graph at a time; a graph is a list of nodes
    (an op's name, or a conditional node with its body graph), each taken
    after the one before."""

    ERR = 900        # cudaErrorStreamCaptureImplicit

    def __init__(self):
        self.capturing = {}          # cuda_stream -> graph (a list)
        self.suspended = {}          # id -> a graph whose capture waits
        self.nodes = {}              # id -> a node a capture resumes after
        self.current = None
        self.handles = 0

    # the library's C interface, as ctypes passes it
    def cg_begin(self, stream, child, kind, flag, handle_ref, graph_ref,
                 node_ref):
        graph = self.capturing.get(stream)
        if graph is None:
            return self.ERR
        node = {"kind": ("IF", "WHILE")[kind], "flag": flag, "body": []}
        graph.append(node)
        if child == stream:
            del self.capturing[stream]           # suspended
            graph_ref._obj.value = id(graph)
            node_ref._obj.value = id(node)
            self.suspended[id(graph)] = graph
            self.nodes[id(node)] = node
        else:
            graph_ref._obj.value = None
            node_ref._obj.value = None
        if child in self.capturing:
            return self.ERR
        self.capturing[child] = node["body"]
        self.handles += 1
        handle_ref._obj.value = self.handles
        node["handle"] = self.handles
        return 0

    def cg_set(self, stream, handle, flag):
        graph = self.capturing.get(stream)
        if graph is None:
            return self.ERR
        graph.append(("set", handle))
        return 0

    def cg_end(self, child, graph, node):
        graph, node = graph.value, node.value      # ctypes.c_void_p
        body = self.capturing.pop(child, None)
        if body is None:
            return self.ERR
        if not body:
            body.append("noop")
        if graph is not None:
            parent = self.suspended.pop(graph)
            assert parent[-1] is self.nodes[node], \
                "resumed after another node than its own"
            self.capturing[child] = parent
        return 0

    def cg_error_string(self, err):
        return b"fake"


@pytest.fixture
def fake_capture(monkeypatch):
    """``_graph`` on a fake library and fake streams: torch.cuda's
    current stream and stream context follow a plain variable."""
    fake = _FakeCapture()
    top, body = _Stream("capture"), _Stream("body")
    fake.current = top
    fake.top_graph = []
    fake.capturing[top.cuda_stream] = fake.top_graph

    @contextlib.contextmanager
    def stream(st):
        before, fake.current = fake.current, st
        try:
            yield
        finally:
            fake.current = before

    monkeypatch.setattr(_graph, "_library", lambda: fake)
    monkeypatch.setattr(_graph, "_body_stream", lambda device: body)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: fake.current)
    monkeypatch.setattr(torch.cuda, "stream", stream)
    fake.top, fake.body = top, body
    return fake


def _op(fake, name):
    """An op enqueued on the current stream lands in the graph that
    stream captures into."""
    fake.capturing[fake.current.cuda_stream].append(name)


def test_every_body_is_captured_on_one_stream_in_graph_order(fake_capture):
    fake = fake_capture
    streams = []
    flag = torch.ones((), dtype=torch.bool)

    def record(name):
        streams.append(fake.current.name)
        _op(fake, name)

    with _graph._body(0, None):              # the root, as capture() opens it
        record("init")

        def trip():
            record("trip head")
            _graph.if_body(flag, lambda: (record("if inner"), _graph.if_body(
                flag, lambda: record("if innermost"))))
            record("trip tail")
            return flag

        _graph.while_body(flag, trip)
        record("after loop")
    # the root forked from the capture stream, which goes on capturing
    # the top graph; every op of every depth was captured on the body
    # stream
    assert set(streams) == {"body"}
    assert fake.capturing == {fake.top.cuda_stream: fake.top_graph}
    [root] = fake.top_graph
    assert root["kind"] == "IF" and root["flag"] is None
    # each graph holds its ops and nodes in the order they were enqueued:
    # the work after a nested body lands in its parent, after the node
    init, loop, after = root["body"]
    assert (init, after) == ("init", "after loop")
    assert loop["kind"] == "WHILE"
    head, inner_if, tail, again = loop["body"]
    assert (head, tail) == ("trip head", "trip tail")
    assert again == ("set", loop["handle"])
    assert inner_if["body"][0] == "if inner"
    assert inner_if["body"][1]["body"] == ["if innermost"]


def test_an_empty_body_gets_a_node_and_the_flag_lives_through_it(
        fake_capture, monkeypatch):
    fake = fake_capture
    made, seen = [], []
    as_flag = _graph._as_flag

    def tracked_flag(pred):
        flag = as_flag(pred)
        made.append(weakref.ref(flag))
        return flag

    monkeypatch.setattr(_graph, "_as_flag", tracked_flag)
    with _graph._body(0, None):
        # a float flag: the node reads a bool made from it, which must
        # outlive the body's capture (the set kernel reads its address)
        _graph.if_body(torch.tensor(3.0), lambda: seen.append(
            made[-1]() is not None))
    assert seen == [True]
    assert made[-1]() is None          # and is released after it
    [root] = fake.top_graph
    assert root["body"][0]["body"] == ["noop"]


def test_a_failed_body_ends_every_capture_it_opened_and_raises(
        fake_capture):
    fake = fake_capture
    flag = torch.ones((), dtype=torch.bool)

    def broken():
        _op(fake, "before")
        raise ValueError("a body failed")

    with pytest.raises(ValueError, match="a body failed"):
        with _graph._body(0, None):
            _graph.if_body(flag, lambda: _graph.if_body(flag, broken))
    # only the top graph's capture (PyTorch's) is still open
    assert fake.capturing == {fake.top.cuda_stream: fake.top_graph}


def test_a_refused_node_raises(fake_capture):
    fake = fake_capture
    del fake.capturing[fake.top.cuda_stream]      # nothing is capturing
    with pytest.raises(RuntimeError, match="adding a conditional node"):
        with _graph._body(0, None):
            pass


# ------------------------------------------------ the eager warm-up


def test_warm_up_tensors_are_released_before_the_rehearsal():
    """``_graph.run`` runs the warm-up (``driver._warm``: every closure
    once at x0) before the solve; by the time the solve starts, nothing
    the warm-up made is alive (on the card the capture starts there)
    but the closures' device constants (``problems/_const.py``), which the
    warm-up is there to make outside every graph."""
    model = et.CnlsModel(**HS65)
    fns = tdrv.Functions(*_model_functions(model, F64, "cpu"))
    x0 = torch.as_tensor(model.starting_point, dtype=F64)
    made = []

    def tracked(f):
        def g(*args):
            out = f(*args)
            made.extend(weakref.ref(t) for t in pytree.tree_leaves(out)
                        if isinstance(t, torch.Tensor))
            return out
        return g

    fns = fns._replace(**{k: tracked(v) for k, v in fns._asdict().items()
                          if callable(v)})
    alive = []

    def solve(x):
        constants = {id(hit[0]) for hit in _const._cache.values()}
        alive.extend(id(r()) for r in made
                     if r() is not None and id(r()) not in constants)
        return x * 2.0

    out = _graph.run(("warm-test",), solve, (x0,), "cpu",
                     warm=lambda: tdrv._warm(fns, x0))
    assert len(made) >= 4, "the warm-up did not call every closure"
    assert alive == []
    assert torch.equal(out, x0 * 2.0)


# ------------------------------------------------ on the card


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: a captured CUDA graph has "
                    "no CPU form")


def _held_to_targets(solve, static_bytes):
    """The eager loop, then the capturing call and a replay of the graph
    path from an empty cache, held to the targets; the figures.  The
    libraries' workspaces of the eager loop's stream and of the body
    stream (made once a process) exist before either is measured."""
    solve(False)
    _graph.warm_up("cuda")
    _graph.clear_graph_cache()
    torch.cuda.reset_peak_memory_stats()
    eager = solve(False)
    torch.cuda.synchronize()
    eager_peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    first = solve(True)
    torch.cuda.synchronize()
    capture_peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved() - reserved0
    replay = solve(True)
    torch.cuda.synchronize()
    figures = {"eager_peak": eager_peak, "capture_peak": capture_peak,
               "held": held, "static": static_bytes}
    _graph.clear_graph_cache()
    assert capture_peak <= 1.5 * eager_peak, figures
    assert held <= 1.25 * eager_peak + static_bytes, figures
    for r in (first, replay):
        assert torch.equal(r.x, eager.x), figures
        assert (r.exit_code, r.n_iter) == (eager.exit_code, eager.n_iter)
    return figures


@pytest.mark.gpu
def test_captured_chained_rosenbrock_holds_the_eager_loops_memory():
    """Needs the card and nvcc (run with ``pytest -m gpu``)."""
    _needs_card()
    n = 200
    model = et.CnlsModel(**chained_rosenbrock(n))
    fns = _solve_functions(model, F64, "cuda")
    x0 = torch.as_tensor(model.starting_point, dtype=F64, device="cuda")
    dims = et.Dims(n, 2 * n - 2, n - 2, n - 2)
    tols = et.Tols.for_dtype(F64, "cuda")
    static = x0.nbytes + sum(t.nbytes for t in tols)
    _held_to_targets(lambda g: tdrv.solve(
        fns, x0, dims, et.Options(second_derivatives=False), tols,
        dtype=F64, graph=g), static)


@pytest.mark.gpu
def test_captured_giant_m_dense_holds_the_eager_loops_memory():
    """Needs the card and nvcc (run with ``pytest -m gpu``)."""
    _needs_card()
    from enlsip_tpu_torch.problems.giant_m import giant_m
    gm = giant_m(200_000, 100, 50, seed=3, dtype=F64, device="cuda")
    tols = et.Tols.for_dtype(F64, "cuda")
    static = gm.x0.nbytes + sum(t.nbytes for t in tols)
    figures = _held_to_targets(lambda g: tdrv.solve(
        gm.dense, gm.x0, gm.dims, et.Options(second_derivatives=False,
                                             max_iter=8), tols,
        dtype=F64, graph=g), static)
    assert figures["held"] > 0, figures


@pytest.mark.gpu
def test_reverse_mode_ad_in_a_body_stays_in_the_graphs_pool():
    """Needs the card and nvcc (run with ``pytest -m gpu``).  A Newton
    step's Hessians (reverse over reverse AD, whose backward ops autograd
    runs on its own device thread) captured in an IF body, then the
    default pool's cache given back to the card and its memory taken by
    other work, then two replays: equal to the eager values to the bit.
    A block of the capture that left the graph's pool is freed after the
    capture while the graph still writes it."""
    _needs_card()
    fns = tdrv.Functions(*_model_functions(et.CnlsModel(**HS65), F64,
                                           "cuda"))
    x = torch.as_tensor(HS65["starting_point"], dtype=F64, device="cuda")
    lam = torch.ones(7, dtype=F64, device="cuda")
    rx = fns.res(x)

    def hess(z):
        return hessian_contractions(fns.res, fns.cons, z, rx, lam)

    want = hess(x)
    key = ("test_reverse_mode_ad_in_a_body",)
    _graph.clear_graph_cache()
    # both sides take the Hessians (one structure and layout); the
    # flag holds, so the first side runs
    got = [_graph.run(key, lambda z: _lanes.cond(
        z[0] == z[0], lambda: hess(z), lambda: hess(z)), (x,), "cuda")]
    got = [tuple(t.clone() for t in got[0])]
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        other = torch.full((1 << 22,), float("nan"), dtype=F64,
                           device="cuda")
        got.append(tuple(t.clone() for t in _graph.run(key, None, (x,),
                                                        "cuda")))
        torch.cuda.synchronize()
        del other
    _graph.clear_graph_cache()
    for g in got:
        assert all(torch.equal(a, b) for a, b in zip(g, want))
