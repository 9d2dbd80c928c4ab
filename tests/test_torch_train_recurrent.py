"""Training the recurrent families -- the ssm family (xlstm_350m) and the
hybrid family (jamba_1_5_large_398b) -- against the JAX reference (CPU,
plain torch).

The models are the reduced ones of ``tests/test_torch_xlstm.py`` and
``tests/test_torch_hybrid.py``, at f32, with their params (the drawn
sLSTM / forget-gate biases and Mamba ``a_log`` / ``conv_b``): xlstm with
3 layers (``slstm_at=(1,)``: mLSTM, sLSTM, mLSTM), jamba as one 8-slot
period with its 4 experts (capacity 2.0, nothing dropped) and as the
dense-slot period (``n_experts=0``, the configuration the card trains).
The reference arm is the jitted ``jnp`` backend with its weight matmuls
summed one k at a time (``chunk1``: ``qmatmul`` and ``qmatmul_batched``
patched on the test side to ``chunk=1``, the port's K order); nothing in
``src/repro`` changes.  Batches come from ``SyntheticLM`` (2 x 16).

Tolerances, each with its reason (measured worst cases in brackets):

* ``fma``'s gradient, on the special-value sample: bit-equal to
  ``jax.vjp`` of the reference's f32 ``a * b + c`` (``g * b``, ``g * a``,
  ``g``: one f32 product each), once XLA's CPU flush of subnormal
  operands and products is applied to the port's products; with
  broadcasting, within rtol 1e-6 (the sums over the broadcast dims run
  in other orders);
* loss and every gradient leaf against ``jax.value_and_grad`` of
  ``Model.loss_fn``, EXACT: the dense family's bounds, rtol 1e-5 on the
  loss and 1e-4 x each leaf's largest gradient [xlstm 7.9e-6, the first
  layer's wv; jamba 2.6e-5, slot 0's ``a_log``; dense-slot jamba 3.7e-5,
  slot 0's ``x_proj``]: f32 sums in other orders (the N = 16 read-out,
  the chunk contractions, XLA's dot);
* RAPID: loss within rtol 2e-3 (the dense family's) [xlstm 3.6e-7,
  jamba 0, dense-slot jamba 1.3e-5]; gradients within 5e-3 x each leaf's
  largest gradient (the dense family's) for xlstm [2.0e-4, ``lm_head``]
  and dense-slot jamba [2.0e-3, slot 7's w1], and within 1e-2
  (JAMBA_RAPID_GRAD) for jamba with its experts [5.7e-3, slot 6's w1].
  That is the forward's held difference (ROADMAP §3, RAPID cell edges in
  chained mixers: a one-ulp operand difference moves an in_proj /
  out_proj / expert operand across an edge of its RAPID coefficient
  cell, and the MoE slots carry it on): the residual stream entering
  slot 6 is ~6e-3 of its largest magnitude off the reference's
  (``tests/test_torch_hybrid.py`` prints the drift slot by slot), and
  w1's gradient is that stream's ln2 times the cotangent;
* remat ``none`` / ``block`` / ``full``: bit-equal losses and gradients
  (the recompute runs the same ops on the same inputs);
* optimizer steps (EXACT): losses within rtol 1e-5, params within 2 x
  lr per step (the dense family's bounds: AdamW and Adafactor move an
  element by about lr in a step, so a near-zero gradient whose sign
  differs between the two f32 orders moves it the other way), gradient
  norms within rtol 1e-4 (the dense family's) for jamba and 3e-4
  (XLSTM_GNORM) for xlstm [4.1e-5 at step 0, 1.1e-4 at step 2]: the
  steps run on the ill-conditioned batch below, and the param moves add
  to it;
* the ill-conditioned batch (``SyntheticLM`` seed 3), on which the first
  mLSTM layer's backward amplifies the rounding of its f32 chunk inputs
  ~35-fold (the ``|n.q|`` normaliser divides by sums with cancellation):
  every gradient leaf within XLSTM_ILL_GRAD x its largest, EXACT 3e-4
  [1.3e-4, layer 0's f_bias], RAPID 5e-3 (the dense family's)
  [3.5e-3, layer 2's wi].  The witness, on the reference's own
  layer input and cotangent, against an f64 VJP written apart from both
  sides: the chunk inputs q, k, v within F32_PRODUCTS 2e-6 of their f64
  values [8.1e-7; the reference's 3.6e-7]; the mixer's output within
  ILL_FORWARD 2e-5 [7.1e-6] and its VJP within ILL_VJP 5e-5 [port
  2.35e-5, reference 3.0e-6, the input's and wq's / wk's] of f64's; and
  the port's VJP within BACKWARD_ROUNDING 1e-5 [2.1e-6] of the f64
  backward evaluated at the port's own chunk inputs, which lands as far
  from f64 as the port does [2.29e-5]: the port's distance is its f32
  forward products' rounding (torch's CPU sgemm against XLA's dot)
  through the condition, not its backward arithmetic;
* checkpoints: file for file equal to the reference's (names, shapes,
  dtypes, values); a resumed loop's losses equal one uninterrupted run's
  within rtol 1e-6.
"""
import json
from functools import lru_cache, partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import torch.nn.functional as F  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_hybrid as th  # noqa: E402
import test_torch_xlstm as tx  # noqa: E402
from _torch_helpers import assert_same_bits, randn, special_sample  # noqa: E402
from repro.ckpt.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.core import ops as jops  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import xlstm as jxl  # noqa: E402
from repro.models.layers import ParallelCtx  # noqa: E402
from repro.train.optimizer import OptConfig as JOptConfig  # noqa: E402
from repro.train.trainstep import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.ckpt.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.core import ops as tops  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.models import xla_math  # noqa: E402
from repro_torch.models import xlstm as txl  # noqa: E402
from repro_torch.models.hybrid import attn_slot  # noqa: E402
from repro_torch.models.params import (load_jax_params, tree_items,  # noqa: E402
                                       tree_leaves)
from repro_torch.train.loop import LoopConfig, train_loop  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402
from repro_torch.train.trainstep import make_train_step  # noqa: E402

CTX = ParallelCtx()
T = torch.from_numpy
XLSTM, JAMBA = tx.ARCH, th.ARCH
VOCAB = 512
JAMBA_RAPID_GRAD = 1e-2
XLSTM_GNORM = 3e-4
# the seed-3 batch (the module docstring): whole-model leaves by arithmetic;
# the first mLSTM layer's VJP against f64; the port's backward against an
# exact one at its own forward values; f32 products against f64
XLSTM_ILL_GRAD = {False: 3e-4, True: 5e-3}
ILL_FORWARD = 2e-5
ILL_VJP = 5e-5
BACKWARD_ROUNDING = 1e-5
F32_PRODUCTS = 2e-6
# model -> (the reference / port pair at an approx flag, the config's arch)
MODELS = {
    "xlstm": (tx._pair, XLSTM),
    "jamba": (th._pair, JAMBA),
    "jamba_dense": (partial(th._pair, dense=True), JAMBA),
}
# the gradient test's cases: (a model of MODELS, the SyntheticLM seed)
GRAD_CASES = {"xlstm": ("xlstm", 1), "jamba": ("jamba", 1),
              "jamba_dense": ("jamba_dense", 1), "xlstm_seed3": ("xlstm", 3)}


@pytest.fixture(scope="module", autouse=True)
def chunk1():
    """The reference's weight matmuls summed one k at a time (the port's
    order) for the whole module: its jitted functions trace inside."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlayers, "qmatmul", partial(jops.qmatmul, chunk=1))
        mp.setattr(jmoe, "qmatmul_batched",
                   partial(jops.qmatmul_batched, chunk=1))
        yield


def _batch(seed=1, step=0):
    return SyntheticLM(VOCAB, 16, 2, seed=seed).batch_at(step)


def _grad_leaves(tm, tp, batch, remat=None):
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss = tm.loss_fn(tp, {k: T(v.copy()) for k, v in batch.items()}, remat)
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    return float(loss.detach()), grads


# --------------------------------------------------------------------------
# fma: the gradient of the reference's a * b + c
# --------------------------------------------------------------------------

def _ftz(x: np.ndarray) -> np.ndarray:
    """float32 ``x`` with every subnormal flushed to a zero of its sign."""
    sub = (x != 0) & (np.abs(x) < np.finfo(np.float32).tiny)
    return np.where(sub, np.copysign(np.float32(0), x), x).astype(np.float32)


def test_fma_grad_matches_reference_on_special_values():
    """``g * b``, ``g * a`` and ``g``: IEEE f32 products, bit for bit
    (numpy's), and XLA's own bits once its CPU runtime's flush of
    subnormals is applied to the products (it reads a subnormal operand
    as zero and flushes a subnormal product to zero; torch and the card
    do neither, and the forward of ``fma`` keeps them too); ``g`` passes
    through unflushed on both sides."""
    rng = np.random.default_rng(0)
    a, b, c, g = (special_sample(rng, 4096) for _ in range(4))

    def port(a, b, c, g):
        ts = [T(v.copy()).requires_grad_(True) for v in (a, b, c)]
        got = torch.autograd.grad(xla_math.fma(*ts), ts, T(g.copy()))
        assert all(x.dtype == torch.float32 for x in got)
        return [x.numpy() for x in got]

    got = port(a, b, c, g)
    with np.errstate(all="ignore"):
        for x, y in zip(got, (g * b, g * a, g)):
            assert_same_bits(x, y)
    _, vjp = jax.vjp(lambda a, b, c: a * b + c,
                     *(jnp.asarray(v) for v in (a, b, c)))
    want = vjp(jnp.asarray(g))
    flushed = port(*(_ftz(v) for v in (a, b, c, g)))
    for x, y in zip(flushed[:2], want[:2]):
        assert_same_bits(_ftz(x), np.asarray(y))
    assert_same_bits(got[2], np.asarray(want[2]))  # g, passed through


def test_fma_grad_sums_broadcast_dims():
    """Operands broadcast as the mixers' are (a per-row decay against a
    state, a per-column bias): each gradient summed down to its input's
    shape, as the reference's transpose of the broadcast."""
    rng = np.random.default_rng(1)
    a, b, c = randn(rng, 64, 1), randn(rng, 64, 48), randn(rng, 48)
    g = randn(rng, 64, 48)
    _, vjp = jax.vjp(lambda a, b, c: a * b + c,
                     *(jnp.asarray(v) for v in (a, b, c)))
    want = vjp(jnp.asarray(g))
    ts = [T(v.copy()).requires_grad_(True) for v in (a, b, c)]
    out = xla_math.fma(*ts)
    got = torch.autograd.grad(out, ts, T(g))
    for x, y, t in zip(got, want, ts):
        assert x.shape == t.shape
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6,
                                   atol=1e-6 * float(np.abs(y).max()))


# --------------------------------------------------------------------------
# loss and every gradient leaf against jax.value_and_grad
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(GRAD_CASES))
@pytest.mark.parametrize("approx", [False, True], ids=["exact", "rapid"])
def test_loss_and_grads_match_reference(case, approx):
    model, seed = GRAD_CASES[case]
    jm, jp, tm, tp = MODELS[model][0](approx)
    batch = _batch(seed)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss_fn(p, b, CTX)))(jp, batch)
    loss, grads = _grad_leaves(tm, tp, batch)
    np.testing.assert_allclose(loss, float(jl), rtol=2e-3 if approx else 1e-5)
    bound = 1e-4
    if seed == 3:
        bound = XLSTM_ILL_GRAD[approx]
    elif approx:
        bound = JAMBA_RAPID_GRAD if model == "jamba" else 5e-3
    want = load_jax_params(jax.tree.map(np.asarray, jg), device="cpu")
    assert [p for p, _ in tree_items(want)] == [p for p, _ in tree_items(tp)]
    worst = (0.0, None)
    for (path, w), g in zip(tree_items(want), grads):
        scale = float(w.abs().max())
        assert bool(torch.isfinite(g).all()), path
        worst = max(worst, (float((g - w).abs().max()) / max(scale, 1e-30),
                            str(path)))
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=bound * scale + 1e-12,
                                   err_msg=str(path))
    print(f"{case} {'RAPID' if approx else 'EXACT'}: loss {loss!r} vs "
          f"{float(jl)!r}, worst gradient leaf {worst[0]:.2e} ({worst[1]})")


# --------------------------------------------------------------------------
# the ill-conditioned batch: xlstm's first mLSTM layer against f64
# --------------------------------------------------------------------------

def record_mixers(jm, jp, batch):
    """``jax.value_and_grad`` of the reference's ``Model.loss_fn`` on
    ``batch``, and every mixer call (``mlstm`` / ``slstm``) in it, in
    layer order: (kind, its input, its output's cotangent), as numpy;
    recorded by a ``jax.debug.callback`` on the input and an identity
    ``custom_vjp`` around the output.  Returns (loss, grads, calls)."""
    seen = {}

    @partial(jax.custom_vjp, nondiff_argnums=(1,))
    def tap(y, i):
        return y

    def tap_bwd(i, _, g):
        jax.debug.callback(lambda v: seen.setdefault((i, "ct"), np.array(v)),
                           g)
        return (g,)
    tap.defvjp(lambda y, i: (y, None), tap_bwd)
    kinds = []

    def wrap(kind, real):
        def mixer(x, p, cfg, ctx):
            i = len(kinds)
            kinds.append(kind)
            jax.debug.callback(
                lambda v: seen.setdefault((i, "x"), np.array(v)), x)
            out, st = real(x, p, cfg, ctx)
            return tap(out, i), st
        return mixer
    with pytest.MonkeyPatch.context() as mp:
        for kind in ("mlstm", "slstm"):
            mp.setattr(jxl, kind, wrap(kind, getattr(jxl, kind)))
        loss, grads = jax.block_until_ready(jax.jit(jax.value_and_grad(
            lambda p: jm.loss_fn(p, batch, CTX)))(jp))
    return loss, grads, [(k, seen[(i, "x")], seen[(i, "ct")])
                         for i, k in enumerate(kinds)]


@lru_cache(maxsize=None)
def _ill_conditioned_mlstm():
    """The reference's first mLSTM layer on the seed-3 batch (EXACT): its
    input, its output's cotangent (:func:`record_mixers`) and its params,
    as numpy."""
    jm, jp, _, _ = tx._pair(False)
    kind, x, ct = record_mixers(jm, jp, _batch(seed=3))[2][0]
    assert kind == "mlstm"
    return x, ct, tx._init_tree()["blocks"]["l0"]["mlstm"]


def _mlstm_f64(x, p, H, at=None):
    """The mLSTM mixer in f64 by its quadratic form (one chunk from the
    empty state: h = (D * s) v / max(|sum (D * s)|, 1), D the decays,
    s = q k^T / sqrt(hd)), written apart from both sides' code.  ``at``
    gives the chunk's inputs (q, k, v, li, lf) values to take in the
    forward while the derivative stays the f64 one: an exact backward
    evaluated at those values."""
    B, S, _ = x.shape
    xi, z = (x @ p["up_proj"]).chunk(2, -1)

    def heads(t):
        return t.reshape(B, S, H, -1).transpose(1, 2)
    ins = {"q": heads(xi @ p["wq"]), "k": heads(xi @ p["wk"]),
           "v": heads(xi @ p["wv"]), "li": (xi @ p["wi"]).transpose(1, 2),
           "lf": F.logsigmoid(xi @ p["wf"] + 3.0 * p["f_bias"]).transpose(
               1, 2)}
    if at is not None:
        ins = {n: t + (at[n].double() - t).detach() for n, t in ins.items()}
    q, k, v, li, lf = ins.values()
    Fc = lf.cumsum(-1)
    logd = Fc[..., :, None] - Fc[..., None, :] + li[..., None, :]
    d = torch.where(torch.ones(S, S, dtype=torch.bool).tril(), logd,
                    -torch.inf).exp()
    s = (q @ k.transpose(-1, -2)) / q.shape[-1] ** 0.5 * d
    h = (s @ v) / torch.maximum(s.sum(-1).abs(),
                                torch.ones((), dtype=s.dtype))[..., None]
    return (h.transpose(1, 2).reshape(B, S, -1) * F.silu(z)) @ p["down_proj"]


def test_mlstm_vjp_against_f64_on_the_ill_conditioned_batch(monkeypatch):
    """The first mLSTM layer's VJP on the reference's own input and
    cotangent (seed 3, EXACT), each side held against the f64 VJP of
    :func:`_mlstm_f64`, and the port's against the f64 backward evaluated
    at its own f32 chunk inputs (the bounds and their reasons: the module
    docstring)."""
    x, ct, p32 = _ill_conditioned_mlstm()
    jc, tc = tx._cfgs(False)
    names = sorted(p32)
    jp = {n: jnp.asarray(p32[n]) for n in names}
    _, vjp = jax.vjp(lambda x, p: jxl.mlstm(x, p, jc, CTX)[0],
                     jnp.asarray(x), jp)
    rx, rp = vjp(jnp.asarray(ct))
    ref = {"x": np.asarray(rx), **{n: np.asarray(rp[n]) for n in names}}

    seen = []
    real = txl._mlstm_core_chunk
    monkeypatch.setattr(txl, "_mlstm_core_chunk", lambda *a: seen.append(
        [t.detach().clone() for t in a[:5]]) or real(*a))
    tx_ = T(x.copy()).requires_grad_(True)
    tp = {n: T(p32[n].copy()).requires_grad_(True) for n in names}
    out = txl.mlstm(tx_, tp, tc)[0]
    got = torch.autograd.grad(out, [tx_] + [tp[n] for n in names],
                              T(ct.copy()))
    port = dict(zip(["x"] + names, (g.numpy() for g in got)))
    assert len(seen) == 1  # S 16: one chunk
    at = dict(zip(("q", "k", "v", "li", "lf"), seen[0]))

    def f64(at=None):
        x64 = torch.from_numpy(x.astype(np.float64)).requires_grad_(True)
        p64 = {n: torch.from_numpy(p32[n].astype(np.float64)).requires_grad_(
            True) for n in names}
        out = _mlstm_f64(x64, p64, jc.n_heads, at)
        g = torch.autograd.grad(out, [x64] + [p64[n] for n in names],
                                torch.from_numpy(ct.astype(np.float64)))
        return dict(zip(["x"] + names, (t.numpy() for t in g))), out
    exact, out64 = f64()
    at_port, _ = f64(at)

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())
    fwd = rel(out.detach().double().numpy(), out64.detach().numpy())
    print(f"forward: {fwd:.2e} of its largest off f64")
    assert fwd <= ILL_FORWARD
    # the chunk inputs against their f64 values (f32 products, rounded)
    f64_ins = {}
    with torch.no_grad():
        x64 = torch.from_numpy(x.astype(np.float64))
        p64 = {n: torch.from_numpy(p32[n].astype(np.float64)) for n in names}
        xi = (x64 @ p64["up_proj"]).chunk(2, -1)[0]
        B, S, _ = x.shape
        for n in ("q", "k", "v"):
            f64_ins[n] = (xi @ p64["w" + n]).reshape(
                B, S, jc.n_heads, -1).transpose(1, 2)
    for n, t in f64_ins.items():
        r = rel(at[n].double().numpy(), t.numpy())
        print(f"chunk input {n}: {r:.2e} of its largest off f64")
        assert r <= F32_PRODUCTS, n
    for n in ["x"] + names:
        r_ref, r_port = rel(ref[n], exact[n]), rel(port[n], exact[n])
        r_at, r_bwd = rel(at_port[n], exact[n]), rel(port[n], at_port[n])
        print(f"{n}: from f64 reference {r_ref:.2e}, port {r_port:.2e}; "
              f"f64 backward at the port's forward values {r_at:.2e}; port "
              f"from that {r_bwd:.2e}")
        assert r_ref <= ILL_VJP and r_port <= ILL_VJP, n
        assert r_bwd <= BACKWARD_ROUNDING, n


# --------------------------------------------------------------------------
# remat: the same bits, and the structure the launch counts show
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def remat_runs():
    """RAPID loss, gradients and the number of K1 calls (``log_matmul``,
    which ``qmatmul`` and ``qmatmul_batched`` both reach) of one
    backward, per remat mode, for reduced xlstm and dense-slot jamba;
    computed once a model."""
    done = {}

    def runs(model):
        if model not in done:
            _, _, tm, tp = MODELS[model][0](True)
            calls = []
            real = tops.log_matmul
            out = {}
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(tops, "log_matmul",
                           lambda *a, **k: calls.append(1) or real(*a, **k))
                for remat in ("none", "block", "full"):
                    calls.clear()
                    out[remat] = (*_grad_leaves(tm, tp, _batch(), remat),
                                  len(calls))
            done[model] = (tm.cfg, out)
        return done[model]

    return runs


@pytest.mark.parametrize("model", ["xlstm", "jamba_dense"])
def test_remat_modes_give_the_same_loss_and_grads(remat_runs, model):
    _, out = remat_runs(model)
    ref_loss, ref, _ = out["none"]
    for remat in ("block", "full"):
        loss, grads, _ = out[remat]
        assert loss == ref_loss, remat
        for a, b in zip(grads, ref):
            assert torch.equal(a, b), remat


def _k1_a_layer(cfg, model) -> list:
    """K1 calls of each layer (xlstm) or slot (jamba) in one forward."""
    if model == "xlstm":  # mLSTM up_proj wq wk wv down_proj; sLSTM w down
        return [2 if i in cfg.slstm_at else 5 for i in range(cfg.n_layers)]
    # a Mamba slot's in_proj out_proj or the attention slot's wq wk wv wo,
    # then the dense FFN's w1 w3 w2
    return [(4 if s == attn_slot(cfg) else 2) + 3
            for s in range(cfg.attn_every)]


@pytest.mark.parametrize("model", ["xlstm", "jamba_dense"])
def test_remat_launch_counts_show_the_checkpoint_structure(remat_runs,
                                                           model):
    """xlstm: a layer recomputes everything at "block" and at "full" (no
    tape: the reference's ``nothing_saveable`` on an ssm layer), so every
    product runs twice.  jamba: each slot is checkpointed inside the
    superblock's checkpoint; at "block" the superblock's recompute runs
    every slot but the last (it stops once it has the last slot's input)
    and each slot's own recompute runs it again: three runs, the last
    slot two; at "full" the superblock's recompute replays the products
    from its tape: two runs."""
    cfg, out = remat_runs(model)
    per = _k1_a_layer(cfg, model)
    n = sum(per)
    counts = {remat: out[remat][2] for remat in out}
    if model == "xlstm":
        assert counts == {"none": n, "block": 2 * n, "full": 2 * n}
    else:
        assert counts == {"none": n, "block": 3 * n - per[-1],
                          "full": 2 * n}


def test_training_configs_match_reference():
    for arch in (XLSTM, JAMBA):
        jc, tc = jget(arch), tget(arch)
        assert (tc.remat, tc.optimizer, tc.lr_schedule) == \
            (jc.remat, jc.optimizer, jc.lr_schedule)
    assert tget(XLSTM).optimizer == "adamw"
    assert tget(JAMBA).optimizer == "adafactor"


# --------------------------------------------------------------------------
# optimizer steps against the reference's make_train_step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["xlstm", "jamba"])
def test_three_optimizer_steps_match_reference(model):
    """Three steps of the config's optimizer (xlstm: AdamW, jamba:
    Adafactor) on its schedule, EXACT."""
    jm, jp, tm, tp = MODELS[model][0](False)
    lr = 1e-3
    kw = dict(name=tm.cfg.optimizer, lr=lr, schedule=tm.cfg.lr_schedule,
              warmup_steps=2, total_steps=5)
    jinit, jstep = jmake_train_step(jm, JOptConfig(**kw), CTX, backend="jnp")
    jstep = jax.jit(jstep)
    tinit, tstep = make_train_step(tm, OptConfig(**kw))
    jopt, topt = jinit(jp), tinit(tp)
    src = SyntheticLM(VOCAB, 16, 2, seed=3)
    for step in range(3):
        batch = src.batch_at(step)
        jp, jopt, jmet = jstep(jp, jopt, batch, jnp.int32(step))
        tp, topt, tmet = tstep(tp, topt, batch, step)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]),
                                   rtol=XLSTM_GNORM if model == "xlstm"
                                   else 1e-4)
        np.testing.assert_allclose(tmet["lr"], float(jmet["lr"]), rtol=1e-6)
    want = load_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    for (path, w), g in zip(tree_items(want), tree_leaves(tp)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=2 * lr * 3, err_msg=str(path))


# --------------------------------------------------------------------------
# checkpoints, the loop, the launcher
# --------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["xlstm", "jamba"])
def test_checkpoint_layout_matches_reference(tmp_path, model):
    """The same params and the config's optimizer state (xlstm: AdamW's
    m / v, jamba: Adafactor's factors) give the same files, with the same
    names, shapes and values, as the reference's checkpoint of its
    unstacked tree (``l{i}`` layers; jamba's ``slot{s}`` subtrees)."""
    jm, jp, tm, tp = MODELS[model][0](False)
    oc = dict(name=tm.cfg.optimizer)
    jopt = jmake_train_step(jm, JOptConfig(**oc), CTX)[0](jp)
    topt = make_train_step(tm, OptConfig(**oc))[0](tp)
    JCheckpointManager(str(tmp_path / "ref")).save(3, jp, jopt)
    CheckpointManager(str(tmp_path / "port")).save(3, tp, topt)
    rdir, pdir = tmp_path / "ref" / "step_00000003", \
        tmp_path / "port" / "step_00000003"
    names = sorted(p.name for p in rdir.iterdir())
    assert names == sorted(p.name for p in pdir.iterdir())
    want = {"xlstm": "params.blocks.l1.slstm.r.npy",
            "jamba": "opt.f.blocks.l0.slot3.mamba.in_proj.c.npy"}[model]
    assert want in names
    rman = json.loads((rdir / "manifest.json").read_text())["arrays"]
    pman = json.loads((pdir / "manifest.json").read_text())["arrays"]
    assert rman == pman
    for name in names:
        if name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(pdir / name),
                                          np.load(rdir / name))


@pytest.mark.parametrize("model", ["xlstm", "jamba"])
def test_loop_resume_continues_the_losses(tmp_path, model):
    """Two steps and a checkpoint, then a restart from other params that
    resumes from it for two more: the losses of one uninterrupted run of
    four, and the same final checkpoint (params and optimizer state)."""
    make = MODELS[model][0]
    tm = make(False)[2]
    init_opt, step = make_train_step(tm, OptConfig(
        name=tm.cfg.optimizer, lr=1e-3, warmup_steps=2, total_steps=4))
    src = SyntheticLM(VOCAB, 16, 2, seed=5)

    def run(params, total, d, every=0):
        lc = LoopConfig(total_steps=total, ckpt_every=every, log_every=0,
                        ckpt_dir=str(tmp_path / d))
        return train_loop(step, params, init_opt(params), src, lc)

    p1 = make(False)[3]
    st1 = run(p1, 2, "split", every=2)
    other = tm.init(9, "cpu")
    st2 = run(other, 4, "split")
    assert (st1.step, st2.step, len(st2.losses)) == (2, 4, 2)
    p3 = make(False)[3]
    st3 = run(p3, 4, "once")
    np.testing.assert_allclose(st1.losses + st2.losses, st3.losses,
                               rtol=1e-6)
    split, once = (tmp_path / d / "step_00000004" for d in ("split", "once"))
    names = sorted(f.name for f in once.glob("*.npy"))
    assert names == sorted(f.name for f in split.glob("*.npy"))
    for name in names:
        np.testing.assert_array_equal(np.load(split / name),
                                      np.load(once / name))


@pytest.mark.parametrize("arch", [XLSTM, JAMBA])
def test_train_cli_trains_the_recurrent_families(tmp_path, capsys, arch):
    from repro_torch.launch.train import main
    assert main(["--arch", arch, "--reduced", "--approx", "--device", "cpu",
                 "--steps", "2", "--batch", "2", "--seq", "16",
                 "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "final loss" in out and "nan" not in out
    assert CheckpointManager(str(tmp_path)).latest_step() == 2

