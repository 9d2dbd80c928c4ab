"""The port's ssm family (xlstm_350m) against the JAX reference (CPU,
plain torch).

Reduced xlstm_350m keeps only the sLSTM blocks among its first two
layers (``reduced()`` drops xlstm's sLSTM layers 5, 13, 21), so the
cases here run ``reduced().with_(n_layers=3, slstm_at=(1,))``: mLSTM,
sLSTM, mLSTM, d_model 128 (mLSTM: up 256, 4 heads of 64; sLSTM: 4 heads
of 32), with the reference's params carried over by ``load_jax_params``.
The reference arm is the jitted ``jnp`` backend with its weight matmuls
summed one k at a time (``chunk1``: ``qmatmul`` patched on the test side
to ``chunk=1``, the port's K order, as ``tests/test_torch_hybrid.py``
does); nothing in ``src/repro`` changes.  The bf16 reference is compiled
with XLA's excess precision off (``_torch_helpers._strict``).

Tolerances (measured worst cases in brackets):

* ``F = cumsum(lf)``, the chunk carry ``wc * C + einsum``, the
  inter-chunk terms ``num + w_st * (q C)``, the decode update ``wf * C +
  wi * (k v^T)`` and the sLSTM update ``f * c + i * z``, given the same
  inputs: bit-equal (XLA's blocked scan, its fused multiply-adds);
* ``log_sigmoid``, ``sigmoid``, ``tanh`` and ``exp`` against XLA's, on a
  seeded sample over [-30, 30]: within 3, 3, 4 and 1 ulp (ACT_ULPS)
  [3, 3, 4, 1];
* the mLSTM mixer, f32, prefill at S = 5, 64 and 100 (one chunk, a
  whole chunk, two chunks with padding) then 3 decode steps on each
  side's own state: output and (C, n, m) within MIXER_RTOL of their
  largest magnitude [1.8e-6 EXACT; 2.4e-5 RAPID, the S = 100 output: a
  one-ulp difference in a K1 operand (the f32 contractions and the rms
  sum run in other orders) can move it across a RAPID coefficient cell];
* the sLSTM mixer, f32, S = 7 then 3 decode steps: output and (c, n, m,
  h) within MIXER_RTOL [5.0e-7];
* each layer, f32, fed the residual stream the reference's layer
  received: within LAYER_RTOL[approx] of the largest magnitude of its
  output [8.2e-7 EXACT, 1.2e-5 RAPID (layer 0, a coefficient cell as
  above)];
* logits, f32, EXACT: atol 4e-5 (EXACT_ATOL) [1.84e-5 forward of
  logits of ~3.7].  The weight matmuls of the exact path and the chunk's
  contractions sum in other orders than XLA's dot (85% of the elements
  of a reduced-shape f32 matmul differ in the last bit from XLA's, and
  an f64-rounded matmul matches it no better), and each layer's
  ``|n.q|`` normaliser divides by a sum with cancellation: the
  difference grows from 7.4e-7 of the stream after layer 0 to 4.4e-6
  after layer 2 (printed by ``test_layers_match_reference_on_its_inputs``);
* logits, f32, RAPID: atol 2e-2 (RAPID_ATOL) [1.8e-3 forward, 9.3e-3 the
  second decode step], logits of magnitude ~3.7;
* logits, bf16, RAPID and EXACT: atol 2^-5 (BF16_ATOL, two bf16 ulps at
  the logits' largest magnitude, ~3.7) [0 RAPID, 1.56e-2 EXACT];
* greedy tokens: 100% equal to the reference's ``ServeEngine``, f32 and
  bf16, RAPID and EXACT, the left-padded rows included (the pads enter
  the recurrence in both).
"""
from functools import lru_cache, partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_helpers import _strict, assert_same_bits, ulp_diff  # noqa: E402
from repro.configs.base import RAPID as JRAPID  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.core import ops as jops  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import xlstm as jxlstm  # noqa: E402
from repro.models.layers import ParallelCtx  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.models.params import P as JP  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro_torch.configs.base import RAPID as TRAPID  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.kernels.fused_div import ops as tdiv  # noqa: E402
from repro_torch.models import xla_math  # noqa: E402
from repro_torch.models import xlstm as txlstm  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.models.params import load_jax_params, tree_items  # noqa: E402
from repro_torch.serve.engine import ServeEngine as TEngine  # noqa: E402
from repro_torch.serve.scheduler import ContinuousServeEngine  # noqa: E402

CTX = ParallelCtx()
T = torch.from_numpy
ARCH = "xlstm_350m"
LOCK = [[1, 2, 3], [4, 5, 6, 7, 8, 9], [10, 11, 12, 13, 14]]
CACHE_N = 32
ACT_ULPS = {"log_sigmoid": 3, "sigmoid": 3, "tanh": 4, "exp": 1}
MIXER_RTOL = 1e-4
LAYER_RTOL = {False: 2e-6, True: 5e-5}
EXACT_ATOL = 4e-5
RAPID_ATOL = 2e-2
BF16_ATOL = 2.0 ** -5


@pytest.fixture(scope="module", autouse=True)
def chunk1():
    """The reference's weight matmuls summed one k at a time (the port's
    order) for the whole module: its jitted functions trace inside."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlayers, "qmatmul", partial(jops.qmatmul, chunk=1))
        yield


def _cfgs(approx, dtype="float32"):
    over = dict(n_layers=3, slstm_at=(1,), dtype=dtype)
    jc = jget(ARCH).reduced().with_(**over)
    tc = tget(ARCH).reduced().with_(**over)
    if approx:
        jc, tc = jc.with_(approx=JRAPID), tc.with_(approx=TRAPID)
    return jc.with_backend("jnp"), tc


@lru_cache(maxsize=None)
def _init_tree():
    """The reference's seeded init of the 3-layer reduced xlstm, as numpy,
    with the sLSTM bias and the mLSTM forget-gate bias drawn away from
    their zeros and ones (so both reach the outputs)."""
    tree = jax.tree.map(np.asarray, JModel(_cfgs(False)[0]).init(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)

    def draw(a, scale, base=0.0):
        return (base + scale * rng.standard_normal(a.shape)).astype(
            np.float32)
    blocks = dict(tree["blocks"])
    for name, lp in tree["blocks"].items():
        if "slstm" in lp:
            sl = lp["slstm"]
            blocks[name] = dict(lp, slstm=dict(sl, bias=draw(sl["bias"],
                                                             0.5)))
        else:
            ml = lp["mlstm"]
            blocks[name] = dict(lp, mlstm=dict(ml, f_bias=draw(
                ml["f_bias"], 0.3, 1.0)))
    return dict(tree, blocks=blocks)


def _pair(approx, dtype="float32"):
    jc, tc = _cfgs(approx, dtype)
    tree = _init_tree()
    return (JModel(jc), jax.tree.map(jnp.asarray, tree), TModel(tc),
            load_jax_params(tree, device="cpu"))


def _layer_params(i, kind):
    tree = _init_tree()["blocks"][f"l{i}"][kind]
    return jax.tree.map(jnp.asarray, tree), load_jax_params(tree,
                                                             device="cpu")


def _padded(prompts):
    toks = np.zeros((len(prompts), max(map(len, prompts))), np.int32)
    for i, p in enumerate(prompts):
        toks[i, toks.shape[1] - len(p):] = p  # left-pad, as the engines
    return toks


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


# --------------------------------------------------------------------------
# config and params
# --------------------------------------------------------------------------

def test_config_and_reduced_keep_the_reference_layers():
    """xlstm_350m field for field, and ``reduced()`` keeping only the
    sLSTM blocks below layer 2, as the reference's."""
    full, ref = tget(ARCH), jget(ARCH)
    for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "d_ff", "vocab_size", "head_dim", "slstm_at"):
        assert getattr(full, f) == getattr(ref, f), f
    assert tget(ARCH).reduced().slstm_at == jget(ARCH).reduced().slstm_at == ()
    assert full.with_(slstm_at=(1, 5)).reduced().slstm_at == (1,)
    tm = TModel(_cfgs(False)[1])
    assert tm._xlstm_kinds() == ["mlstm", "slstm", "mlstm"]
    assert TModel(full)._xlstm_kinds().count("slstm") == 3


def test_load_jax_params_carries_xlstm_layers():
    """The reference's tree (its shapes those of its spec tree) arrives
    leaf for leaf in the port's own spec tree: a list of ``{"ln",
    "mlstm" | "slstm"}`` layers."""
    tree = _init_tree()
    ref_specs = JModel(_cfgs(False)[0]).param_specs()
    assert jax.tree.map(np.shape, tree) == jax.tree.map(
        lambda p: tuple(p.shape), ref_specs, is_leaf=lambda x: isinstance(
            x, JP))
    tp = load_jax_params(tree, device="cpu")
    specs = TModel(_cfgs(False)[1]).param_specs()
    assert [p for p, _ in tree_items(tp)] == [p for p, _ in tree_items(
        specs)]
    assert [sorted(b) for b in tp["blocks"]] == [
        ["ln", "mlstm"], ["ln", "slstm"], ["ln", "mlstm"]]
    for path, got in tree_items(tp):
        leaf = dict(tree, blocks=[tree["blocks"][f"l{i}"] for i in range(3)])
        for key in path:
            leaf = leaf[key]
        np.testing.assert_array_equal(got.numpy(), leaf, err_msg=str(path))


# --------------------------------------------------------------------------
# the parts where XLA's grouping and contraction are matched: bits
# --------------------------------------------------------------------------

@pytest.mark.parametrize("L", [64, 40, 16])
def test_blocked_cumsum_bits(L):
    """``F = cumsum(lf)`` as the reference's jitted ``jnp.cumsum`` over a
    chunk of L log forget gates: the same bits (``torch.cumsum`` groups
    otherwise and differs in about half the elements)."""
    rng = np.random.default_rng(L)
    lf = -np.abs(rng.standard_normal((2, 4, L))).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=-1))(lf))
    assert_same_bits(txlstm.blocked_cumsum(T(lf)).numpy(), want)


@pytest.mark.parametrize("L", [64, 5])
def test_chunk_carry_and_state_terms_bits(L):
    """The chunk's state terms in its FMA forms, the contractions given:
    the carry ``wc * C + E`` and ``wc * n + e`` (E, e the einsums over the
    chunk's L steps) and the inter-chunk terms ``num + w_st * (q C)`` and
    ``den + w_st * (q n)``, against the reference's expressions jitted:
    the same bits (one fused multiply-add each)."""
    rng = np.random.default_rng(L)
    B, H, hd = 2, 4, 64

    def randn(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    wc = rng.uniform(0, 1, (B, H)).astype(np.float32)
    w_st = rng.uniform(0, 1, (B, H, L)).astype(np.float32)
    Ch, E, nh, e = randn(B, H, hd, hd), randn(B, H, hd, hd), randn(
        B, H, hd), randn(B, H, hd)
    num, qC, den, qn = randn(B, H, L, hd), randn(B, H, L, hd), randn(
        B, H, L), randn(B, H, L)
    want = jax.jit(lambda wc, Ch, E, nh, e, w, num, qC, den, qn: (
        wc[..., None, None] * Ch + E, wc[..., None] * nh + e,
        num + w[..., None] * qC, den + w * qn))(
        wc, Ch, E, nh, e, w_st, num, qC, den, qn)
    fma = xla_math.fma
    got = (fma(T(wc)[..., None, None], T(Ch), T(E)),
           fma(T(wc)[..., None], T(nh), T(e)),
           fma(T(w_st)[..., None], T(qC), T(num)),
           fma(T(w_st), T(qn), T(den)))
    for g, w in zip(got, want):
        assert_same_bits(g.numpy(), np.asarray(w))


def test_decode_and_slstm_updates_bits():
    """The mLSTM decode update ``wf * C + wi * (k v^T)``, ``wf * n + wi *
    k`` and the sLSTM update ``f * c + i * z``, ``f * n + i`` on the same
    inputs as the reference's expressions jitted: the same bits (the left
    product fused, the right one rounded)."""
    rng = np.random.default_rng(1)
    B, H, hd = 3, 4, 64
    wf, wi = (rng.uniform(0, 1, (B, H)).astype(np.float32) for _ in range(2))
    Ch = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    nh, kf, vf = (rng.standard_normal((B, H, hd)).astype(np.float32)
                  for _ in range(3))

    def dec(wf, Ch, nh, wi, kf, vf):
        return (wf[..., None, None] * Ch + wi[..., None, None] * (
            kf[..., :, None] * vf[..., None, :]),
            wf[..., None] * nh + wi[..., None] * kf)
    want = jax.jit(dec)(wf, Ch, nh, wi, kf, vf)
    got = txlstm.mlstm_decode_update(*map(T, (wf, Ch, nh, wi, kf, vf)))
    for g, w in zip(got, want):
        assert_same_bits(g.numpy(), np.asarray(w))

    f_p, i_p = (rng.uniform(0, 1, (B, H, 32)).astype(np.float32)
                for _ in range(2))
    c, n, z = (rng.standard_normal((B, H, 32)).astype(np.float32)
               for _ in range(3))
    want = jax.jit(lambda f, c, n, i, z: (f * c + i * z, f * n + i))(
        f_p, c, n, i_p, z)
    got = txlstm.slstm_update(*map(T, (f_p, c, n, i_p, z)))
    for g, w in zip(got, want):
        assert_same_bits(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("name", sorted(ACT_ULPS))
def test_activations_within_ulps(name):
    """The gates' elementwise functions against XLA's on a seeded sample
    over [-30, 30] and a unit normal: within ACT_ULPS[name] ulp.
    ``log_sigmoid`` takes the reference's steps (``-softplus(-x)``,
    ``logaddexp(x, 0)``)."""
    fns = {"log_sigmoid": (jax.nn.log_sigmoid, xla_math.log_sigmoid),
           "sigmoid": (jax.nn.sigmoid, torch.sigmoid),
           "tanh": (jnp.tanh, torch.tanh), "exp": (jnp.exp, torch.exp)}
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-30, 30, 100_000),
                        3 * rng.standard_normal(100_000)]).astype(np.float32)
    jf, tf = fns[name]
    u = ulp_diff(tf(T(x)).numpy(), np.asarray(jax.jit(jf)(x)))
    print(f"{name}: max {u.max()} ulp, {np.mean(u > 0):.2%} differ")
    assert u.max() <= ACT_ULPS[name]


def test_q_scale_is_the_reciprocal_multiply():
    """``q / jnp.sqrt(hd)`` under jit is XLA's multiply by the f32
    reciprocal (bit-equal to it; a true divide differs at hd 512), and
    the port's ``q * _attn_scale(hd)`` gives its bits at both mLSTM head
    widths (64 reduced, 512 full)."""
    from repro_torch.models.layers import _attn_scale
    q = np.random.default_rng(2).standard_normal(50_000).astype(np.float32)
    for hd in (64, 512):
        want = np.asarray(jax.jit(lambda q: q / jnp.sqrt(hd))(q))
        assert_same_bits((T(q) * _attn_scale(hd)).numpy(), want)
    assert not np.array_equal(q / np.float32(np.sqrt(np.float32(512))),
                              want)


# --------------------------------------------------------------------------
# the mixers against the reference
# --------------------------------------------------------------------------

def _decode_steps(jstep, tstep, jstate, cache, rng, n=3):
    """``n`` decode steps on each side's own state; the port's cache is
    written in place.  Yields (rel out, rel of each state tensor)."""
    addr = [t.data_ptr() for t in cache.values()]
    for _ in range(n):
        xd = rng.standard_normal((2, 128)).astype(np.float32)
        out, jstate = jstep(xd, jstate)
        tout, cache = tstep(T(xd), cache)
        assert [t.data_ptr() for t in cache.values()] == addr
        yield _rel(tout, out), [_rel(t, j) for t, j in zip(cache.values(),
                                                           jstate)]


@pytest.mark.parametrize("S,approx", [(5, True), (64, False), (100, False),
                                      (100, True)])
def test_mlstm_and_decode_match_reference(S, approx):
    """The mLSTM prefill form on 2 x S tokens (one short chunk, a whole
    chunk, two chunks with the second padded: the carry taken at the
    padded chunk's end), output and (C, n, m) within MIXER_RTOL of their
    largest magnitude; then 3 decode steps on each side's own state."""
    jc, tc = _cfgs(approx)
    jp, tp = _layer_params(0, "mlstm")
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, 128)).astype(np.float32)
    out, st = jax.jit(lambda x, p: jxlstm.mlstm(x, p, jc, CTX))(x, jp)
    tout, tst = txlstm.mlstm(T(x), tp, tc)
    rel = [_rel(tout, out)] + [_rel(t, j) for t, j in zip(tst.values(),
                                                           st)]
    print(f"S={S} approx={approx}: out / C / n / m rel {rel}")
    assert tout.shape == out.shape and max(rel) <= MIXER_RTOL
    jstep = jax.jit(lambda x, s: jxlstm.mlstm_decode(x, s, jp, jc, CTX))
    for i, (r, rs) in enumerate(_decode_steps(
            jstep, lambda x, c: txlstm.mlstm_decode(x, c, tp, tc), st,
            tst, rng)):
        print(f"  decode {i}: out {r:.2e}, C / n / m {rs}")
        assert max([r] + rs) <= MIXER_RTOL


@pytest.mark.parametrize("approx", [True, False])
def test_slstm_and_decode_match_reference(approx):
    """The sLSTM loop over 2 x 7 tokens: output and (c, n, m, h) within
    MIXER_RTOL; then 3 decode steps on each side's own state."""
    jc, tc = _cfgs(approx)
    jp, tp = _layer_params(1, "slstm")
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 7, 128)).astype(np.float32)
    out, st = jax.jit(lambda x, p: jxlstm.slstm(x, p, jc, CTX))(x, jp)
    tout, tst = txlstm.slstm(T(x), tp, tc)
    rel = [_rel(tout, out)] + [_rel(t, j) for t, j in zip(tst.values(),
                                                           st)]
    print(f"approx={approx}: out / c / n / m / h rel {rel}")
    assert max(rel) <= MIXER_RTOL
    jstep = jax.jit(lambda x, s: jxlstm.slstm_decode(x, s, jp, jc, CTX))
    for i, (r, rs) in enumerate(_decode_steps(
            jstep, lambda x, c: txlstm.slstm_decode(x, c, tp, tc), st,
            tst, rng)):
        print(f"  decode {i}: out {r:.2e}, c / n / m / h {rs}")
        assert max([r] + rs) <= MIXER_RTOL


def test_normalisers_take_k5_and_k6(monkeypatch):
    """Under RAPID the mLSTM normaliser divides rows of hd by one
    denominator each (K5's wrapper, ``div_rowbcast``: B x H rows of 64 a
    decode step), the sLSTM one elementwise (K6's, ``div_elementwise``:
    B x H x 32); EXACT takes neither."""
    calls = []
    for name in ("div_rowbcast", "div_elementwise"):
        fn = getattr(tdiv, name)
        monkeypatch.setattr(tdiv, name, lambda a, b, s, fn=fn, name=name: (
            calls.append((name, tuple(a.shape))), fn(a, b, s))[1])
    for approx in (True, False):
        tc = _cfgs(approx)[1]
        x = torch.randn((2, 128), generator=torch.Generator().manual_seed(0))
        calls.clear()
        txlstm.mlstm_decode(x, txlstm.mlstm_init_cache(tc, 2),
                            _layer_params(0, "mlstm")[1], tc)
        txlstm.slstm_decode(x, txlstm.slstm_init_cache(tc, 2),
                            _layer_params(1, "slstm")[1], tc)
        assert calls == ([("div_rowbcast", (8, 64)),
                          ("div_elementwise", (2, 4, 32))] if approx else [])


# --------------------------------------------------------------------------
# the model and the engine
# --------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _reference_run(approx, dtype):
    """The reference (compiled by ``_strict``) on LOCK, as numpy: its
    forward logits, the residual stream entering each of its 3 layers and
    its final norm (a ``jax.debug.callback`` on the input of every
    ``apply_norm`` of the model), prefill + 2 decode steps' logits (its
    engine's compiled steps) and its ``ServeEngine``'s greedy tokens."""
    jm, jp, _, _ = _pair(approx, dtype)
    toks = jnp.asarray(_padded(LOCK))
    seen = []

    def record(x, *args, **kw):
        jax.debug.callback(lambda v: seen.append(np.array(v)), x,
                           ordered=True)
        return jmodel_norm(x, *args, **kw)
    jmodel_norm = jmodel.apply_norm
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmodel, "apply_norm", record)
        fwd = _strict(jax.jit(lambda p, t: jm.forward(p, {"tokens": t},
                                                      CTX)))(jp, toks)
        fwd = np.asarray(fwd, np.float32)
    assert len(seen) == 4
    jeng = JEngine(jm, jp, CTX, cache_n=CACHE_N)
    jeng._prefill, jeng._decode = _strict(jeng._prefill), _strict(
        jeng._decode)
    jl, jc = jeng._prefill(jp, {"tokens": toks})
    assert "slots" not in jc
    steps = [np.asarray(jl, np.float32)]
    for _ in range(2):
        nt = jnp.asarray(np.asarray(jl).argmax(-1).astype(np.int32))
        jl, jc = jeng._decode(jp, nt, jc)
        steps.append(np.asarray(jl, np.float32))
    return fwd, seen, steps, jeng.generate(LOCK, max_new=4)


def _check_model(approx, dtype, atol):
    """``forward``, ``prefill`` and two chained ``decode_step`` logits
    within ``atol`` of the reference's, the greedy choices equal, then the
    lockstep engine's greedy tokens 100% equal to the reference's
    ``ServeEngine`` on three left-padded prompts, one trace each."""
    fwd, _, steps, ref_tokens = _reference_run(approx, dtype)
    _, _, tm, tp = _pair(approx, dtype)
    near = partial(np.testing.assert_allclose, atol=atol, rtol=0)
    toks = T(_padded(LOCK))
    got = tm.forward(tp, {"tokens": toks}).float().numpy()
    print(f"approx={approx} {dtype}: forward max |diff| "
          f"{np.abs(got - fwd).max():.3e} of {np.abs(fwd).max():.2f}")
    near(got, fwd)
    tl, tc = tm.prefill(tp, {"tokens": toks}, CACHE_N)
    assert "slots" not in tc and int(tc["pos"]) == toks.shape[1]
    for i, want in enumerate(steps):
        got = tl.float().numpy()
        print(f"  step {i}: max |diff| {np.abs(got - want).max():.3e}")
        near(got, want)
        nt = want.argmax(-1).astype(np.int32)
        assert np.array_equal(got.argmax(-1), nt)
        if i < len(steps) - 1:
            tl, tc = tm.decode_step(tp, T(nt), tc)
    eng = TEngine(tm, tp, cache_n=CACHE_N)
    assert eng.generate(LOCK, max_new=4) == ref_tokens
    assert eng.trace_counts == {"decode": 1, "prefill": 1}


@pytest.mark.parametrize("approx", [True, False])
def test_logits_and_greedy_tokens_match_reference(approx):
    """f32: logits within RAPID_ATOL / EXACT_ATOL, greedy tokens 100%
    equal (:func:`_check_model`)."""
    _check_model(approx, "float32", RAPID_ATOL if approx else EXACT_ATOL)


@pytest.mark.parametrize("approx", [True, False])
def test_bf16_matches_reference(approx):
    """The card's configuration, bf16 activations, against the reference
    compiled with XLA's excess precision off: logits within BF16_ATOL,
    greedy tokens 100% equal."""
    _check_model(approx, "bfloat16", BF16_ATOL)


@pytest.mark.parametrize("approx", [True, False])
def test_layers_match_reference_on_its_inputs(approx):
    """Each layer of the port (``x + mixer(ln(x))``) fed the residual
    stream the reference's layer received, over the whole sequence (f32):
    within LAYER_RTOL[approx] of the largest magnitude of the reference
    layer's output.  The port's own chain is printed beside it."""
    _, streams, _, _ = _reference_run(approx, "float32")
    _, _, tm, tp = _pair(approx)
    own = T(streams[0])
    for i, lp in enumerate(tp["blocks"]):
        got = txlstm.layer_apply(T(streams[i]), lp, tm.cfg)[0]
        own = txlstm.layer_apply(own, lp, tm.cfg)[0]
        rel, drift = _rel(got, streams[i + 1]), _rel(own, streams[i + 1])
        print(f"approx={approx} layer {i}: on the reference's input "
              f"{rel:.2e}, chained {drift:.2e} of "
              f"{np.abs(streams[i + 1]).max():.1f}")
        assert rel <= LAYER_RTOL[approx], i


def test_decode_cache_holds_the_xlstm_state():
    """The cache has no ``slots``; the engine's persistent decode cache
    (B read from a layer leaf) receives every leaf of prefill's cache:
    each mLSTM layer's C / n / m and the sLSTM layer's c / n / m / h."""
    _, _, tm, tp = _pair(False)
    empty = tm.init_cache(3, CACHE_N, "cpu")
    assert set(empty) == {"pos", "layers"}
    assert [sorted(lc) for lc in empty["layers"]] == [
        ["C", "m", "n"], ["c", "h", "m", "n"], ["C", "m", "n"]]
    assert empty["layers"][0]["C"].shape == (3, 4, 64, 64)
    assert float(empty["layers"][1]["m"].max()) == np.float32(-1e30)
    eng = TEngine(tm, tp, cache_n=CACHE_N)
    _, cache = tm.prefill(tp, {"tokens": T(_padded(LOCK))}, CACHE_N)
    static = eng._decode_cache(cache)
    assert static is not cache
    for (path, src), (_, dst) in zip(tree_items(cache["layers"]),
                                     tree_items(static["layers"])):
        assert dst.data_ptr() != src.data_ptr(), path
        assert torch.equal(dst, src), path
    assert eng._decode_cache(cache) is static


def test_paged_routes_refuse_xlstm():
    """The continuous engine, ``decode_paged`` and the paged cache raise
    ``ValueError`` for the ssm family, as the reference's."""
    _, _, tm, tp = _pair(False)
    with pytest.raises(ValueError, match="dense/moe"):
        ContinuousServeEngine(tm, tp)
    with pytest.raises(ValueError, match="recurrent state"):
        tm.init_paged_cache(4, 8, "cpu")
    z = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="recurrent state"):
        tm.decode_paged(tp, z, {}, z, z[0], z[0] + 1)


def test_launcher_serves_xlstm_lockstep(capsys):
    """``launch/serve.py`` serves reduced xlstm_350m on the CPU through
    the lockstep engine; ``--continuous`` raises."""
    from repro_torch.launch import serve
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--approx",
            "--batch", "2", "--max-new", "3", "--cache", "16"]
    assert serve.main(argv) == 0
    out = capsys.readouterr().out
    assert "6 tokens" in out and out.count("req") == 2
    assert "{'decode': 1, 'prefill': 1}" in out
    with pytest.raises(ValueError, match="dense/moe"):
        serve.main(argv + ["--continuous"])
