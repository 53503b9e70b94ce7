"""Shared helpers of the ``test_torch_*`` files: hand the JAX package's
structures over to the PyTorch port as nested dicts of numpy arrays, and
compute a file's costly reference once for all the workers of a run."""

import fcntl
import os
import sys

import numpy as np
import pytest
import torch

from enlsip_tpu_torch.utils.convert import from_reference

CPU = torch.device("cpu")
F64 = torch.float64

# The port's tests work on small tensors, and the suite runs one worker
# process a core or more (pytest-xdist); torch's default of one intra-op
# thread a core in every worker oversubscribes the machine and slows the
# other workers' tests, the timed ones among them.
torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def release_jax_executables():
    """At the end of each test module that imports it: drop the JAX
    package's compiled executables (``jax.clear_caches()``).  XLA maps
    memory for every executable it builds and a process may hold at most
    ``vm.max_map_count`` maps; a worker that carries a file's executables
    into the next JAX-heavy file (``test_hs_suite.py``'s module fixture
    adds some 35,000 maps) can cross that limit, and XLA's compiler then
    dies of a segmentation fault (``probe_map_count.py`` measures it).
    The caches are dropped only once the process holds more than
    ``MAP_COUNT_TO_RELEASE`` maps, so a worker that runs a module's tests
    in several turns does not compile them again each time."""
    yield
    if "jax" in sys.modules and _map_count() > MAP_COUNT_TO_RELEASE:
        sys.modules["jax"].clear_caches()


# Well under the 65,530 maps a Linux process may hold by default, less the
# ~35,000 that the heaviest module fixture of the suite adds.
MAP_COUNT_TO_RELEASE = 16_000


def _map_count() -> int:
    """Memory maps this process holds (every map counts where /proc is
    missing, so the caches are always dropped there)."""
    try:
        with open("/proc/self/maps") as f:
            return sum(1 for _ in f)
    except OSError:
        return MAP_COUNT_TO_RELEASE + 1


def run_dir(tmp_path_factory):
    """The directory every pytest-xdist worker of one run shares (the
    parent of each worker's base temporary directory), or the base
    temporary directory of a run without workers."""
    base = tmp_path_factory.getbasetemp()
    return base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base


def computed_once(tmp_path_factory, key: str, compute):
    """``compute()``, run by the first worker of the run that asks for
    ``key`` and loaded from disk by every other.

    Under ``--dist load`` the tests of one file are spread over the
    workers, and each worker that runs one of them runs the file's module
    fixtures again: a JAX reference solve, a set of gloo ranks.  The
    result (tensors, numpy arrays and plain containers of them; JAX
    arrays become numpy arrays) is saved with ``torch.save`` under a file
    lock, so a worker that asks while another computes waits for it."""
    path = run_dir(tmp_path_factory) / f"computed_once_{key}.pt"
    with open(f"{path}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if path.exists():
                return torch.load(path, weights_only=False)
            out = _to_numpy_leaves(compute())
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            torch.save(out, tmp)
            os.replace(tmp, path)
            return out
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _to_numpy_leaves(obj):
    """JAX arrays inside ``obj`` (NamedTuples, tuples, lists, dicts) as
    numpy arrays; everything else as it is."""
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_numpy_leaves(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy_leaves(v) for v in obj)
    if isinstance(obj, dict):
        return {k: _to_numpy_leaves(v) for k, v in obj.items()}
    if type(obj).__module__.startswith("jax"):
        return np.asarray(obj)
    return obj


def ref_tree(obj):
    """A JAX-side structure (NamedTuple of arrays, possibly nested) as
    nested dicts of numpy arrays, class name under ``_type``."""
    if obj is None:
        return None
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        out = {"_type": type(obj).__name__}
        out.update({k: ref_tree(getattr(obj, k)) for k in obj._fields})
        return out
    if type(obj).__name__ in _CLASS_FIELDS:     # pytree classes, not tuples
        out = {"_type": type(obj).__name__}
        out.update({k: ref_tree(getattr(obj, k))
                    for k in _CLASS_FIELDS[type(obj).__name__]})
        return out
    if isinstance(obj, (list, tuple)):
        return type(obj)(ref_tree(v) for v in obj)
    return np.asarray(obj)


# The two-stage tall factorizations of the JAX package are registered
# pytree classes; their members by name.
_CLASS_FIELDS = {"CholQRF": ("M", "R1", "f2", "R2", "G", "jtrx"),
                 "TSQRF": ("qloc", "f2", "axis")}


def to_port(obj):
    """JAX-side structure -> the port's structure (CPU, float64)."""
    return from_reference(ref_tree(obj), CPU, F64)


def tt(a, dtype=None):
    """numpy -> CPU tensor (float64 for floats)."""
    a = np.asarray(a)
    if dtype is None and a.dtype.kind == "f":
        dtype = F64
    return torch.tensor(a, dtype=dtype)


# ------------------------------------------------------- twin problems

def twin_data(seed, n, m, q, n_ineq, lower=(), upper=(), dup_eq=False,
              scale=1.0):
    """Numpy data of a small random CNLS instance (see
    :func:`twin_callables`).  ``dup_eq`` repeats the first equality row
    (a rank-deficient active set); ``scale`` scales the residuals."""
    rng = np.random.default_rng(seed)
    d = dict(B=rng.normal(size=(m, n)) * scale, C=rng.normal(size=(m, n)),
             y=rng.normal(size=m) * scale, E=rng.normal(size=(q, n)),
             e=rng.normal(size=q) * 0.3, G=rng.normal(size=(n_ineq, n)),
             g=rng.uniform(0.5, 2.0, n_ineq),
             lo=-rng.uniform(0.2, 1.0, len(lower)),
             up=rng.uniform(0.2, 1.0, len(upper)))
    if dup_eq and q >= 2:
        d["E"][1], d["e"][1] = d["E"][0], d["e"][0]
    x0 = rng.normal(size=n) * 0.5
    return d, x0


def twin_callables(d, lower, upper, xp, cat, as_index=lambda a: a):
    """(res, cons) on the array library ``xp`` from data ``d`` (arrays of
    that library; for JAX they may be traced):

        r(x)   = B x - y + 0.3 sin(C x)
        eq(x)  = E x + 0.05 (E x)^2 - e
        ineq(x) = g - G x - 0.1 (x . x)
        bounds x_i >= lo_i (i in ``lower``), x_i <= up_i (i in ``upper``)

    stacked as [eq; ineq; x - lo; up - x].  ``as_index`` makes the bound
    index arrays the library's own, once (a torch closure then copies no
    host data at a call, as a captured solve requires)."""
    lower, upper = np.asarray(lower, int), np.asarray(upper, int)
    lower_i, upper_i = as_index(lower), as_index(upper)

    def res(x):
        return d["B"] @ x - d["y"] + 0.3 * xp.sin(d["C"] @ x)

    def cons(x):
        parts = []
        if d["E"].shape[0]:
            ex = d["E"] @ x
            parts.append(ex + 0.05 * ex ** 2 - d["e"])
        if d["G"].shape[0]:
            parts.append(d["g"] - d["G"] @ x - 0.1 * xp.sum(x * x))
        if len(lower):
            parts.append(x[lower_i] - d["lo"])
        if len(upper):
            parts.append(d["up"] - x[upper_i])
        return cat(parts)

    return res, cons


def twin_jax_functions(d, lower, upper):
    """The four JAX callables (r, J, c, A) from (possibly traced) data."""
    import jax
    import jax.numpy as jnp
    res, cons = twin_callables({k: jnp.asarray(v) for k, v in d.items()},
                               lower, upper, jnp, jnp.concatenate)
    return res, jax.jacfwd(res), cons, jax.jacfwd(cons)


def twin_torch_functions(d, lower, upper):
    res, cons = twin_callables(
        {k: torch.tensor(v, dtype=F64) for k, v in d.items()}, lower, upper,
        torch, torch.cat, torch.as_tensor)
    return res, torch.func.jacfwd(res), cons, torch.func.jacfwd(cons)


def twin_functions(seed, n, m, q, n_ineq, lower=(), upper=(), dup_eq=False,
                   scale=1.0):
    """Twin callables of one instance: (jax r/J/c/A, torch r/J/c/A, x0,
    (n, m, q, l))."""
    d, x0 = twin_data(seed, n, m, q, n_ineq, lower, upper, dup_eq, scale)
    l = q + n_ineq + len(lower) + len(upper)
    return (twin_jax_functions(d, lower, upper),
            twin_torch_functions(d, lower, upper), x0, (n, m, q, l))


# ------------------------------------------------------ batched solves

def lane_of(carry, b):
    """Lane ``b`` of a batched port ``Carry`` as one solve's carry (0-d
    tensors where the batch keeps per-lane ones, its own display
    buffer)."""
    def pick(v):
        if isinstance(v, tuple):
            return type(v)(*(pick(u) for u in v))
        return v[b]

    one = pick(carry)
    return one._replace(display=one.display.clone())


def flat_fields(nt, prefix=""):
    """A (nested) NamedTuple as {dotted field name: tensor}."""
    out = {}
    for k, v in zip(nt._fields, nt):
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            out.update(flat_fields(v, prefix + k + "."))
        else:
            out[prefix + k] = torch.as_tensor(v)
    return out


def hs65_batch_setup(B=8, seed=0):
    """HS65 on both sides: (jax fns, torch fns, starts (B, 3), dims
    tuple, JAX-side default tolerances as floats)."""
    import enlsip_tpu as ej
    import enlsip_tpu_torch as et
    import problems as jprob
    from enlsip_tpu.core.driver import Functions as JF
    from enlsip_tpu.models.model import build_constraint_functions as jbuild
    from enlsip_tpu_torch.core.driver import Functions as TF
    from enlsip_tpu_torch.models.model import _model_functions
    from enlsip_tpu_torch.problems import classic as tprob

    jcons, jjac = jbuild(ej.CnlsModel(**jprob.HS65))
    jf = JF(res=jprob.HS65["residuals"],
            jac_res=jprob.HS65["jacobian_residuals"], cons=jcons,
            jac_cons=jjac)
    tf = TF(*_model_functions(et.CnlsModel(**tprob.HS65), F64, CPU))
    rng = np.random.default_rng(seed)
    x0 = np.asarray(tprob.HS65["starting_point"])
    starts = x0[None, :] + 0.3 * rng.normal(size=(B, 3))
    return jf, tf, starts, (3, 3, 0, 7)
