"""The port's top-k (reflow_tpu_torch/kernels/topk.py) against the JAX
package's: the plain version against the Pallas kernel (interpret mode)
and ``jax.lax.top_k``, the scan step ``topk_merge`` against the JAX
scan's step, and ``chunked_corpus_topk`` against the JAX one. Inputs are
made with numpy from a seed and handed to both packages.

On the CPU the port's ``topk`` and ``topk_merge`` take their plain
versions (the tensors lie on the CPU); the CUDA kernels themselves are
held to the plain versions, exactly, by ``chip_smoke.py`` phase 3 and by
the ``cuda``-marked tests below on a machine with a card.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reflow_tpu_torch.kernels import topk as ptopk

# the JAX package's kernels/__init__ re-exports the function ``topk``,
# which shadows the module of that name as a package attribute
jtopk = importlib.import_module("reflow_tpu.kernels.topk")

NEG = ptopk.NEG


def _rows(kind: str, q: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.standard_normal((q, n)).astype(np.float32)
    if kind == "ties":
        # few distinct values: every selection breaks ties by column
        return rng.integers(0, 3, size=(q, n)).astype(np.float32)
    if kind == "partly_neg":
        x = rng.standard_normal((q, n)).astype(np.float32)
        x[:, 3:] = NEG                     # fewer than k real values
        x[::2, :] = NEG                    # and some rows with none
        return x
    if kind == "all_neg":
        return np.full((q, n), NEG, np.float32)
    raise ValueError(kind)


CASES = [("random", 16, 256, 8), ("random", 9, 200, 5),
         ("ties", 16, 300, 12), ("ties", 8, 130, 1),
         ("partly_neg", 16, 200, 8), ("all_neg", 8, 100, 4),
         ("random", 4, 77, 77)]


def _check_against(pv, pi, jv, ji):
    """Values exact everywhere; ids exact wherever the value is above NEG
    (on a row with fewer than k real values the Pallas kernel repeats
    column ids among the NEG slots, the port takes distinct columns —
    every consumer masks those ids to -1)."""
    np.testing.assert_array_equal(pv, jv)
    real = pv > NEG
    np.testing.assert_array_equal(pi[real], ji[real])


@pytest.mark.parametrize("kind,q,n,k", CASES)
def test_plain_matches_pallas_interpret(kind, q, n, k):
    x = _rows(kind, q, n, seed=q * 1000 + n)
    pv, pi = ptopk.topk_plain(torch.from_numpy(x), k)
    jv, ji = jtopk._topk_pallas(jnp.asarray(x), k, interpret=True)
    _check_against(pv.numpy(), pi.numpy(), np.asarray(jv), np.asarray(ji))
    assert pi.dtype == torch.int32 and pv.dtype == torch.float32


@pytest.mark.parametrize("kind,q,n,k", CASES)
def test_wrapper_on_cpu_matches_lax_top_k(kind, q, n, k):
    x = _rows(kind, q, n, seed=7 + n)
    pv, pi = ptopk.topk(torch.from_numpy(x), k)
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    # lax.top_k also takes distinct columns, lowest first: ids exact
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))


def test_wrapper_refuses_bad_input():
    x = torch.zeros((4, 10))
    with pytest.raises(ValueError):
        ptopk.topk(x, 11)                  # k > N
    with pytest.raises(ValueError):
        ptopk.topk(x, 0)
    with pytest.raises(TypeError):
        ptopk.topk(x.double(), 3)
    with pytest.raises(ValueError):
        ptopk.topk(torch.zeros(10), 3)


def _corpus(q, d, dim, seed, dead_every=5):
    rng = np.random.default_rng(seed)
    qv = rng.standard_normal((q, dim)).astype(np.float32)
    dv = rng.standard_normal((d, dim)).astype(np.float32)
    qv /= np.linalg.norm(qv, axis=1, keepdims=True)
    dv /= np.linalg.norm(dv, axis=1, keepdims=True)
    live = np.ones(d, bool)
    live[::dead_every] = False
    return qv, dv, live


@pytest.mark.parametrize("chunk", [64, 256])
def test_chunked_corpus_topk_f32_matches_jax(chunk):
    qv, dv, live = _corpus(12, 256, 32, seed=chunk)
    jv, ji = jtopk.chunked_corpus_topk(
        jnp.asarray(qv), jnp.asarray(dv), jnp.asarray(live), 6, chunk,
        use_pallas=False, precision=jax.lax.Precision.HIGHEST)
    pv, pi = ptopk.chunked_corpus_topk(
        torch.from_numpy(qv), torch.from_numpy(dv), torch.from_numpy(live),
        6, chunk)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    # float32 sums in another order: a few ulp of a unit-range score
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), atol=1e-5)
    assert not np.isin(pi.numpy(), np.nonzero(~live)[0]).any()


def _recall(a, b):
    return np.mean([len(set(x) & set(y)) / len(x) for x, y in zip(a, b)])


@pytest.mark.parametrize("doc", ["bf16", "int8"])
def test_chunked_corpus_topk_low_precision_matches_jax(doc):
    qv, dv, live = _corpus(16, 512, 64, seed=11)
    if doc == "int8":
        from reflow_tpu.workloads.knn import quantize_int8

        d8 = quantize_int8(dv)
        jd, pd = jnp.asarray(d8), torch.from_numpy(d8)
    else:
        jd = jnp.asarray(dv, jnp.bfloat16)
        pd = torch.from_numpy(dv).to(torch.bfloat16)
    jq = jnp.asarray(qv, jnp.bfloat16)
    pq = torch.from_numpy(qv).to(torch.bfloat16)
    jv, ji = jtopk.chunked_corpus_topk(jq, jd, jnp.asarray(live), 8, 128,
                                       use_pallas=False)
    pv, pi = ptopk.chunked_corpus_topk(pq, pd, torch.from_numpy(live), 8,
                                       128)
    # the same bf16 operands summed in float32 in another order: scores
    # within 1e-2 (the bf16 inputs' own rounding scale), and near-equal
    # scores may swap places, so ids are held by recall
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), atol=1e-2)
    assert _recall(pi.numpy(), np.asarray(ji)) >= 0.95


def test_score_form_int8_matches_jax_bit_for_bit():
    v = np.random.default_rng(3).integers(-127, 128, (64, 32)
                                          ).astype(np.int8)
    p = ptopk.score_form(torch.from_numpy(v)).float().numpy()
    j = np.asarray(jtopk.score_form(jnp.asarray(v)).astype(jnp.float32))
    np.testing.assert_array_equal(p, j)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the top-k kernel has no CPU mode "
                    "(chip_smoke.py phase 3 checks it on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind,q,n,k", CASES)
def test_kernel_matches_plain_on_card(cuda_device, kind, q, n, k):
    x = torch.from_numpy(_rows(kind, q, n, seed=5)).to(cuda_device)
    before = ptopk.TOPK_LAUNCHES
    kv, ki = ptopk.topk(x, k)
    pv, pi = ptopk.topk_plain(x, k)
    assert ptopk.TOPK_LAUNCHES == before + 1
    assert torch.equal(kv, pv) and torch.equal(ki, pi)


# -- the scan step: topk_merge ----------------------------------------------

#: (kind, q, k, n): the carry and chunk shapes of each merge case
MERGE_CASES = [("neg_carry", 8, 6, 256), ("dead_chunk", 8, 6, 256),
               ("partly_neg", 8, 6, 300), ("int_ties", 8, 6, 256),
               ("carry_best", 8, 6, 256), ("k1", 8, 1, 130),
               ("random", 4, 16, 513)]


def _merge_case(kind, q, k, n, seed):
    """(carry_vals, carry_ids, scores, live, lo) as numpy: the carry is a
    previous step's output (values descending, distinct ids below lo)."""
    rng = np.random.default_rng(seed)
    lo = 4 * n
    cv = -np.sort(-rng.standard_normal((q, k)).astype(np.float32), axis=1)
    ci = np.stack([rng.permutation(lo)[:k] for _ in range(q)]
                  ).astype(np.int32)
    s = rng.standard_normal((q, n)).astype(np.float32)
    live = rng.random(n) < 0.8
    if kind == "neg_carry":               # the scan's first step
        cv[:] = NEG
        ci[:] = -1
    elif kind == "dead_chunk":
        live[:] = False
    elif kind == "partly_neg":            # NEG in both halves
        cv[:, k // 2:] = NEG
        ci[:, k // 2:] = -1
        s[:, 2:] = NEG
        s[::2] = NEG
    elif kind == "int_ties":              # exact ties across the boundary
        cv = -np.sort(-rng.integers(0, 3, (q, k)), axis=1).astype(np.float32)
        s = rng.integers(0, 3, (q, n)).astype(np.float32)
    elif kind == "carry_best":            # the chunk changes nothing
        cv += 10.0
    return cv, ci, s, live, lo


def _merge_by_topk_plain(cv, ci, s, live, lo):
    """The step as topk_plain on the concatenation, then the id gather."""
    q, n = s.shape
    cand = np.concatenate([cv, np.where(live[None, :], s, NEG)], axis=1)
    cand_ids = np.concatenate(
        [ci, np.broadcast_to(lo + np.arange(n, dtype=np.int32), (q, n))],
        axis=1)
    v, sel = ptopk.topk_plain(torch.from_numpy(cand), cv.shape[1])
    return v.numpy(), np.take_along_axis(cand_ids, sel.long().numpy(), 1)


@pytest.mark.parametrize("kind,q,k,n", MERGE_CASES)
def test_merge_plain_matches_topk_on_concatenation(kind, q, k, n):
    cv, ci, s, live, lo = _merge_case(kind, q, k, n, seed=n + k)
    pv, pi = ptopk.topk_merge_plain(*map(torch.from_numpy, (cv, ci, s, live)),
                                    lo)
    ev, ei = _merge_by_topk_plain(cv, ci, s, live, lo)
    np.testing.assert_array_equal(pv.numpy(), ev)
    np.testing.assert_array_equal(pi.numpy(), ei)
    assert pv.dtype == torch.float32 and pi.dtype == torch.int32


@pytest.mark.parametrize("kind,q,k,n", MERGE_CASES)
def test_merge_matches_jax_step(kind, q, k, n):
    """The JAX scan's step with the Pallas kernel (interpret mode):
    concatenate, top-k, take the ids along. Values exact; ids exact
    wherever the value is above NEG (see _check_against)."""
    cv, ci, s, live, lo = _merge_case(kind, q, k, n, seed=3 * n + k)
    cand = jnp.concatenate([jnp.asarray(cv), jnp.where(
        jnp.asarray(live)[None, :], jnp.asarray(s), NEG)], axis=1)
    cand_ids = jnp.concatenate([jnp.asarray(ci), jnp.broadcast_to(
        lo + jnp.arange(n, dtype=jnp.int32), (q, n))], axis=1)
    jv, sel = jtopk._topk_pallas(cand, k, interpret=True)
    ji = jnp.take_along_axis(cand_ids, sel, axis=1)
    pv, pi = ptopk.topk_merge(*map(torch.from_numpy, (cv, ci, s, live)), lo)
    _check_against(pv.numpy(), pi.numpy(), np.asarray(jv), np.asarray(ji))


def test_merge_writes_out_on_cpu():
    cv, ci, s, live, lo = _merge_case("random", 4, 5, 64, seed=1)
    args = list(map(torch.from_numpy, (cv, ci, s, live)))
    out = (torch.empty((4, 5)), torch.empty((4, 5), dtype=torch.int32))
    got = ptopk.topk_merge(*args, lo, out=out)
    assert got[0] is out[0] and got[1] is out[1]
    ev, ei = ptopk.topk_merge_plain(*args, lo)
    assert torch.equal(out[0], ev) and torch.equal(out[1], ei)


def test_merge_refuses_bad_input():
    *arrays, lo = _merge_case("random", 4, 5, 64, seed=2)
    cv, ci, s, live = map(torch.from_numpy, arrays)
    with pytest.raises(ValueError):
        ptopk.topk_merge(cv, ci[:, :4], s, live, lo)       # ids shape
    with pytest.raises(ValueError):
        ptopk.topk_merge(cv, ci, s, live[:10], lo)         # live length
    with pytest.raises(TypeError):
        ptopk.topk_merge(cv, ci.long(), s, live, lo)       # id dtype
    with pytest.raises(TypeError):
        ptopk.topk_merge(cv, ci, s, live.int(), lo)        # mask dtype


def test_chunked_corpus_topk_integer_ties_match_jax():
    """Integer-valued embeddings: scores are exact small integers, so equal
    scores straddle every chunk boundary and the carry's earlier (lower)
    ids must win them, as in the JAX scan."""
    rng = np.random.default_rng(17)
    qv = rng.integers(-1, 2, (10, 8)).astype(np.float32)
    dv = rng.integers(-1, 2, (512, 8)).astype(np.float32)
    live = rng.random(512) < 0.9
    jv, ji = jtopk.chunked_corpus_topk(
        jnp.asarray(qv), jnp.asarray(dv), jnp.asarray(live), 12, 64,
        use_pallas=False, precision=jax.lax.Precision.HIGHEST)
    pv, pi = ptopk.chunked_corpus_topk(
        torch.from_numpy(qv), torch.from_numpy(dv), torch.from_numpy(live),
        12, 64)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    # the ties are real: some row's k-th score recurs past its k-th id
    full = np.where(live[None, :], qv @ dv.T, NEG)
    assert any((full[r] == pv.numpy()[r, -1]).sum()
               > (pv.numpy()[r] == pv.numpy()[r, -1]).sum()
               for r in range(10))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,q,k,n", MERGE_CASES)
def test_merge_kernel_matches_plain_on_card(cuda_device, kind, q, k, n):
    cv, ci, s, live, lo = _merge_case(kind, q, k, n, seed=9)
    args = [torch.from_numpy(a).to(cuda_device) for a in (cv, ci, s, live)]
    before = ptopk.TOPK_MERGE_LAUNCHES
    kv, ki = ptopk.topk_merge(*args, lo)
    pv, pi = ptopk.topk_merge_plain(*args, lo)
    assert ptopk.TOPK_MERGE_LAUNCHES == before + 1
    assert torch.equal(kv, pv) and torch.equal(ki, pi)
