"""Shared helpers of the ``test_torch_*`` files: hand the JAX package's
structures over to the PyTorch port as nested dicts of numpy arrays."""

import numpy as np
import torch

from enlsip_tpu_torch.utils.convert import from_reference

CPU = torch.device("cpu")
F64 = torch.float64

# The port's tests work on small tensors, and the suite runs one worker
# process a core or more (pytest-xdist); torch's default of one intra-op
# thread a core in every worker oversubscribes the machine and slows the
# other workers' tests, the timed ones among them.
torch.set_num_threads(1)


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
