"""Numpy comparison helpers for holding this package against a
reference, free of JAX: the reference side's values arrive as numpy
arrays or nested dicts of them (see ``utils/convert.py``)."""

from __future__ import annotations

import numpy as np

from .utils.convert import to_numpy


def max_abs_diff(actual, desired) -> float:
    a, d = np.asarray(actual, dtype=float), np.asarray(desired, dtype=float)
    if a.size == 0:
        return 0.0
    return float(np.max(np.abs(a - d)))


def assert_close(actual, desired, atol: float, rtol: float = 0.0,
                 what: str = "") -> None:
    """Floating values within ``atol + rtol * |desired|``; integer and
    boolean values exactly."""
    a, d = np.asarray(to_numpy(actual)), np.asarray(desired)
    assert a.shape == d.shape, f"{what}: shape {a.shape} != {d.shape}"
    if d.dtype.kind in "iub" and a.dtype.kind in "iub":
        np.testing.assert_array_equal(a.astype(np.int64), d.astype(np.int64),
                                      err_msg=what)
    else:
        np.testing.assert_allclose(a.astype(float), d.astype(float),
                                   atol=atol, rtol=rtol, err_msg=what)


def assert_tree_close(actual, desired, atol: float, rtol: float = 0.0,
                      skip=(), what: str = "") -> None:
    """Compare a structure of this package (or its ``to_numpy`` dict)
    against a reference dict field by field; fields named in ``skip`` and
    fields the port does not carry are left out."""
    actual = to_numpy(actual)
    if isinstance(desired, dict):
        for k, v in desired.items():
            if k == "_type" or k in skip or k not in actual:
                continue
            assert_tree_close(actual[k], v, atol, rtol, skip, f"{what}.{k}")
    elif desired is None:
        assert actual is None, what
    else:
        assert_close(actual, desired, atol, rtol, what)
