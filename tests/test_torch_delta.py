"""The port's host delta batch (``reflow_tpu_torch.delta``) against
``tests/test_delta.py`` and the JAX package's ``DeltaBatch``, on the CPU.

Every test of ``tests/test_delta.py`` has a counterpart here: each builds
the same batch in both packages and holds the port's result to the JAX
package's, and to the values the reference test asserts.
"""

import numpy as np
import torch

from reflow_tpu import delta as J
from reflow_tpu_torch import delta as P


def test_empty():
    for pkg in (J, P):
        b = pkg.DeltaBatch.empty()
        assert len(b) == 0
        assert len(pkg.DeltaBatch.concat([b, b])) == 0
    assert P.DeltaBatch.empty().values.shape == \
        J.DeltaBatch.empty().values.shape


def test_from_pairs_and_consolidate():
    got = {}
    for name, pkg in (("jax", J), ("port", P)):
        b = pkg.DeltaBatch.from_pairs([("a", 1), ("b", 2), ("a", 1)])
        assert len(b) == 3
        got[name] = b.consolidate().to_counter()
    assert got["port"] == {("a", 1): 2, ("b", 2): 1}
    assert got["port"] == got["jax"]


def test_retraction_cancels():
    for pkg in (J, P):
        ins = pkg.DeltaBatch.from_pairs([("a", 1)])
        ret = pkg.DeltaBatch.from_pairs([("a", 1)], weight=-1)
        assert pkg.DeltaBatch.concat([ins, ret]).consolidate() \
            .to_counter() == {}


def test_numeric_columns():
    got = {}
    for name, pkg in (("jax", J), ("port", P)):
        b = pkg.DeltaBatch(np.array([3, 1, 3]), np.array([1.0, 2.0, 3.0]),
                           np.array([1, 1, -1]))
        got[name] = pkg.collection_counter([b])
    assert got["port"] == {(3, 1.0): 1, (1, 2.0): 1, (3, 3.0): -1}
    assert got["port"] == got["jax"]


def test_spec():
    """The reference's Spec takes a numpy dtype; the port's takes that or
    a ``torch.dtype``, and an empty batch has the same value shape."""
    js = J.Spec((768,), np.float32).with_key_space(1000)
    for dt in (np.float32, torch.float32):
        s = P.Spec((768,), dt).with_key_space(1000)
        assert s.key_space == js.key_space == 1000
        e = P.DeltaBatch.empty(s)
        assert e.values.shape == J.DeltaBatch.empty(js).values.shape \
            == (0, 768)
