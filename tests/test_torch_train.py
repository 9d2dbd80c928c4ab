"""The port's training path against the JAX reference (CPU, plain torch).

Straight-through gradients per op, reduced-model losses and gradients,
optimizer steps on the cosine and wsd schedules, convergence and
gradient accumulation (mirroring ``tests/test_train_ckpt_data.py``),
remat modes, checkpoints, the loop, the data pipeline and error-feedback
compression.  Inputs come from numpy seeds; reference params go through
``load_jax_params``; the reference arm is the ``jnp`` backend.

Tolerances, each with its reason:

* per-op gradients: rtol 1e-5 (both sides differentiate the same exact
  f32 expression; torch and XLA order their f32 sums differently), with
  an absolute floor of 1e-6 x the gradient's largest magnitude for the
  elements that cancel to near zero;
* reduced-model loss and gradients, EXACT: rtol 1e-5 on the loss, 1e-4
  x each leaf's largest gradient (f32 sums in two orders, through two
  layers and a 512-way logsumexp);
* RAPID: the reference's model matmuls sum in chunks of 64, the port's
  one k at a time (ROADMAP §3; logits within 2.3e-3): loss within rtol
  2e-3, gradients within 5e-3 x each leaf's largest gradient (measured
  worst 2.6e-3, reduced h2o_danube_1_8b's layer-1 wk);
* optimizer steps (EXACT): losses within rtol 1e-5; params within
  2 x lr per step (AdamW moves an element by about lr x sign(g) in its
  first steps, so a gradient near 0 whose sign differs between the two
  f32 orders moves it the other way).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_helpers import perturb_ln, randn  # noqa: E402
from repro.ckpt.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.configs.base import RAPID as JRAPID  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.core import backend as jbe  # noqa: E402
from repro.core import float_approx as jfa  # noqa: E402
from repro.core import ops as jops  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models.layers import ParallelCtx  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.train.compression import ef_compress as jef_compress  # noqa: E402
from repro.train.optimizer import OptConfig as JOptConfig  # noqa: E402
from repro.train.trainstep import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.ckpt.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs.base import RAPID as TRAPID  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.core import backend as tbe  # noqa: E402
from repro_torch.core import float_approx as tfa  # noqa: E402
from repro_torch.core import ops as tops  # noqa: E402
from repro_torch.data.pipeline import (BinCorpus, SyntheticLM,  # noqa: E402
                                       host_slice, make_source)
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.models.params import (load_jax_params, tree_items,  # noqa: E402
                                       tree_leaves)
from repro_torch.train.compression import ef_compress, ef_state  # noqa: E402
from repro_torch.train.loop import LoopConfig, train_loop  # noqa: E402
from repro_torch.train.optimizer import OptConfig, make_schedule  # noqa: E402
from repro_torch.train.trainstep import (make_eval_step,  # noqa: E402
                                         make_train_step)

CTX = ParallelCtx()
T = torch.from_numpy


def _close(got, want, rtol=1e-5, floor=1e-6):
    want = np.asarray(want, np.float32)
    atol = floor * float(np.abs(want).max(initial=0.0))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=atol)


def _torch_grads(fn, *arrays):
    """Gradients of ``fn(*tensors)`` (a scalar) w.r.t. every tensor."""
    ts = [None if a is None else T(a.copy()).requires_grad_(True)
          for a in arrays]
    fn(*ts).backward()
    return [None if t is None else t.grad.numpy() for t in ts]


def _jax_grads(fn, *arrays):
    idx = [i for i, a in enumerate(arrays) if a is not None]

    def f(*live):
        full = list(arrays)
        for i, v in zip(idx, live):
            full[i] = v
        return fn(*full)

    gs = jax.grad(f, argnums=tuple(range(len(idx))))(
        *[jnp.asarray(arrays[i]) for i in idx])
    out = [None] * len(arrays)
    for i, g in zip(idx, gs):
        out[i] = np.asarray(g)
    return out


# --------------------------------------------------------------------------
# straight-through gradients, per op
# --------------------------------------------------------------------------

_MATMUL_CASES = {
    "plain": dict(),
    "bias_silu": dict(bias=True, act="silu"),
    "residual": dict(residual=True),
    "rms_tail": dict(residual=True, norm="rms"),
    "softmax_tail": dict(bias=True, norm="softmax"),
    "rms_keep_prenorm": dict(residual=True, norm="rms", keep=True),
}


@pytest.mark.parametrize("case", list(_MATMUL_CASES))
def test_qmatmul_grads_match_reference(case):
    c = _MATMUL_CASES[case]
    rng = np.random.default_rng(len(case))
    m, k, n = 6, 40, 24
    x, w = randn(rng, 2, m // 2, k), randn(rng, k, n, scale=0.2)
    b = randn(rng, n) if c.get("bias") else None
    r = randn(rng, 2, m // 2, n) if c.get("residual") else None
    if c.get("norm") == "softmax":  # positive rows, as the combine sees
        x, w = np.abs(x), np.abs(w)
    cot = randn(rng, 2, m // 2, n)
    cot2 = randn(rng, 2, m // 2, n)
    keep = c.get("keep", False)
    jep = jbe.Epilogue(activation=c.get("act"), norm=c.get("norm"),
                       div_scheme="rapid9" if c.get("norm") else None,
                       keep_prenorm=keep)
    tep = tbe.Epilogue(activation=c.get("act"), norm=c.get("norm"),
                       div_scheme="rapid9" if c.get("norm") else None,
                       keep_prenorm=keep)

    def loss(out, to):  # to: numpy -> the framework's array
        if keep:
            return (out[0] * to(cot)).sum() + (out[1] * to(cot2)).sum()
        return (out * to(cot)).sum()

    want = _jax_grads(lambda x, w, b, r: loss(jops.qmatmul(
        x, w, "rapid10", backend="jnp", bias=b, residual=r, epilogue=jep),
        jnp.asarray), x, w, b, r)
    got = _torch_grads(lambda x, w, b, r: loss(tops.qmatmul(
        x, w, "rapid10", bias=b, residual=r, epilogue=tep), T), x, w, b, r)
    for g, wnt in zip(got, want):
        if wnt is not None:
            _close(g, wnt)


@pytest.mark.parametrize("bias_kind", [None, "shared", "per_batch"])
def test_qmatmul_batched_grads_match_reference(bias_kind):
    rng = np.random.default_rng(3)
    x, w = randn(rng, 3, 5, 16), randn(rng, 3, 16, 7, scale=0.3)
    b = {None: None, "shared": randn(rng, 7),
         "per_batch": randn(rng, 3, 7)}[bias_kind]
    cot = randn(rng, 3, 5, 7)
    want = _jax_grads(lambda x, w, b: (jops.qmatmul_batched(
        x, w, "rapid10", backend="jnp", bias=b, activation="silu")
        * cot).sum(), x, w, b)
    got = _torch_grads(lambda x, w, b: (tops.qmatmul_batched(
        x, w, "rapid10", bias=b, activation="silu") * T(cot)).sum(), x, w, b)
    for g, wnt in zip(got, want):
        if wnt is not None:
            _close(g, wnt)


@pytest.mark.parametrize("b_shape", [(4, 9), (4, 1), (9,)])
def test_qdiv_grads_match_reference(b_shape):
    rng = np.random.default_rng(len(b_shape))
    a = randn(rng, 4, 9)
    b = np.abs(randn(rng, *b_shape)) + 0.5
    cot = randn(rng, 4, 9)
    want = _jax_grads(lambda a, b: (jops.qdiv(a, b, "rapid9", backend="jnp")
                                    * cot).sum(), a, b)
    got = _torch_grads(lambda a, b: (tops.qdiv(a, b, "rapid9") * T(cot))
                       .sum(), a, b)
    for g, wnt in zip(got, want):
        _close(g, wnt)


@pytest.mark.parametrize("op", ["approx_mul", "approx_div"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b_shape", [(4, 8), (8,), (4, 1)])
def test_approx_mul_div_grads_match_reference(op, dtype, b_shape):
    """``float_approx.approx_mul`` / ``approx_div`` at their default
    schemes pass the ideal product's / quotient's gradient through, as
    the reference's ``custom_jvp`` rules do, in the inputs' dtype."""
    rng = np.random.default_rng(len(b_shape) + len(op))
    a = randn(rng, 4, 8)
    b = np.abs(randn(rng, *b_shape)) + 0.5
    cot = randn(rng, 4, 8)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jfn, tfn = getattr(jfa, op), getattr(tfa, op)
    want = jax.grad(lambda a, b: (jfn(a, b) * cot.astype(jdt)).sum(),
                    argnums=(0, 1))(jnp.asarray(a, jdt), jnp.asarray(b, jdt))
    ta, tb = (T(v).to(tdt).requires_grad_(True) for v in (a, b))
    got = torch.autograd.grad((tfn(ta, tb) * T(cot).to(tdt)).sum(), (ta, tb))
    for g, w, t in zip(got, want, (ta, tb)):
        assert g.dtype == tdt and g.shape == t.shape
        _close(g.float().numpy(), np.asarray(w, np.float32))


def test_approx_mul_div_without_grad_unchanged():
    """Under ``no_grad`` (the apps' arithmetic) the ops give the log-domain
    bits and track nothing."""
    rng = np.random.default_rng(5)
    a, b = T(randn(rng, 4, 8)), T(np.abs(randn(rng, 8)) + 0.5)
    for op, log_op, lut, scheme in (
            ("approx_mul", tfa.log_mul_f32, tfa.mul_lut_device, "rapid10"),
            ("approx_div", tfa.log_div_f32, tfa.div_lut_device, "rapid9")):
        with torch.no_grad():
            got = getattr(tfa, op)(a.requires_grad_(True), b, scheme)
        assert not got.requires_grad
        want = log_op(a.detach(), b, lut(scheme, a.device))
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.numpy().view(np.int32))


@pytest.mark.parametrize("op", ["qsoftmax_div", "qrms_div", "approx_softmax",
                                "approx_mean", "approx_rms_normalize"])
def test_row_op_grads_match_reference(op):
    rng = np.random.default_rng(len(op))
    x = randn(rng, 5, 200)
    if op == "qsoftmax_div":
        x = np.exp(x)
    cot = randn(rng, 5) if op == "approx_mean" else randn(rng, 5, 200)
    jfn = {"qsoftmax_div": lambda v: jops.qsoftmax_div(v, "rapid9", "jnp"),
           "qrms_div": lambda v: jops.qrms_div(v, 1e-6, "rapid9", "jnp"),
           "approx_softmax": lambda v: jops.approx_softmax(
               v, -1, "rapid9", "jnp"),
           "approx_mean": lambda v: jops.approx_mean(v, -1, "rapid9", "jnp"),
           "approx_rms_normalize": lambda v: jops.approx_rms_normalize(
               v, 1e-6, "rapid9", "jnp")}[op]
    tfn = {"qsoftmax_div": lambda v: tops.qsoftmax_div(v, "rapid9"),
           "qrms_div": lambda v: tops.qrms_div(v, 1e-6, "rapid9"),
           "approx_softmax": lambda v: tops.approx_softmax(v, -1, "rapid9"),
           "approx_mean": lambda v: tops.approx_mean(v, -1, "rapid9"),
           "approx_rms_normalize": lambda v: tops.approx_rms_normalize(
               v, 1e-6, "rapid9")}[op]
    # the forwards agree too (the RAPID divides, bit for bit or at ulps)
    np.testing.assert_allclose(tfn(T(x)).numpy(), np.asarray(jfn(x)),
                               rtol=1e-6, atol=0)
    (want,) = _jax_grads(lambda v: (jfn(v) * cot).sum(), x)
    (got,) = _torch_grads(lambda v: (tfn(v) * T(cot)).sum(), x)
    _close(got, want)


def test_approx_softmax_over_another_axis():
    x = randn(np.random.default_rng(0), 6, 4, 3)
    got = tops.approx_softmax(T(x), 1, "rapid9").numpy()
    want = np.asarray(jops.approx_softmax(jnp.asarray(x), 1, "rapid9", "jnp"))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


# --------------------------------------------------------------------------
# reduced models: loss and full gradients
# --------------------------------------------------------------------------

def _pair(arch, approx, **over):
    jc = jget(arch).reduced().with_(dtype="float32", **over)
    tc = tget(arch).reduced().with_(dtype="float32", **over)
    if approx:
        jc, tc = jc.with_(approx=JRAPID), tc.with_(approx=TRAPID)
    jc = jc.with_backend("jnp")
    jm, tm = JModel(jc), TModel(tc)
    jp = perturb_ln(jm.init(jax.random.PRNGKey(0)))
    tp = load_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _batch(vocab, b=2, s=16, seed=1):
    return SyntheticLM(vocab, s, b, seed=seed).batch_at(0)


def _grad_leaves(tm, tp, batch, remat=None):
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    tb = {k: T(v.copy()) for k, v in batch.items()}
    loss = tm.loss_fn(tp, tb, remat)
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    return float(loss.detach()), grads


@pytest.mark.parametrize("arch,approx", [
    ("h2o_danube_1_8b", False), ("h2o_danube_1_8b", True),
    ("minicpm_2b", False), ("minicpm_2b", True),
    ("starcoder2_7b", False), ("starcoder2_7b", True)])
def test_loss_and_grads_match_reference(arch, approx):
    jm, jp, tm, tp = _pair(arch, approx)
    batch = _batch(512)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss_fn(p, b, CTX)))(jp, batch)
    loss, grads = _grad_leaves(tm, tp, batch)
    tol = 2e-3 if approx else 1e-5
    np.testing.assert_allclose(loss, float(jl), rtol=tol)
    want = load_jax_params(jax.tree.map(np.asarray, jg), device="cpu")
    for (path, w), g in zip(tree_items(want), grads):
        scale = float(w.abs().max())
        np.testing.assert_allclose(
            g.numpy(), w.numpy(), rtol=0,
            atol=(5e-3 if approx else 1e-4) * scale + 1e-12,
            err_msg=str(path))


@pytest.mark.parametrize("approx", [False, True])
def test_remat_modes_give_the_same_loss_and_grads(approx):
    """Block remat (checkpointed blocks) and full remat (matmul outputs
    taped) recompute the same numbers: equal bits to no remat."""
    _, _, tm, tp = _pair("h2o_danube_1_8b", approx)
    batch = _batch(512)
    ref_loss, ref = _grad_leaves(tm, tp, batch, "none")
    for remat in ("block", "full"):
        loss, grads = _grad_leaves(tm, tp, batch, remat)
        assert loss == ref_loss
        for a, b in zip(grads, ref):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="remat"):
        _grad_leaves(tm, tp, batch, "some")


def test_full_remat_replays_instead_of_relaunching(monkeypatch):
    _, _, tm, tp = _pair("h2o_danube_1_8b", True)
    calls = []
    real = tops.log_matmul
    monkeypatch.setattr(tops, "log_matmul",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    batch = _batch(512)
    counts = {}
    for remat in ("none", "block", "full"):
        calls.clear()
        _grad_leaves(tm, tp, batch, remat)
        counts[remat] = len(calls)
    n_layers, per_block = 2, 7  # wq wk wv wo+ln2 w1 w3 w2
    assert counts["none"] == counts["full"] == n_layers * per_block
    assert counts["block"] == 2 * n_layers * per_block


def test_training_configs_match_reference():
    for arch in ("h2o_danube_1_8b", "minicpm_2b", "yi_6b"):
        jc, tc = jget(arch), tget(arch)
        assert (tc.remat, tc.optimizer, tc.lr_schedule) == \
            (jc.remat, jc.optimizer, jc.lr_schedule)
        assert tc.reduced().remat == jc.reduced().remat == "none"


# --------------------------------------------------------------------------
# optimizer steps
# --------------------------------------------------------------------------

@pytest.mark.parametrize("schedule,approx", [("cosine", False), ("wsd", False),
                                             ("cosine", True)])
def test_three_adamw_steps_match_reference(schedule, approx):
    jm, jp, tm, tp = _pair("h2o_danube_1_8b", approx)
    lr = 1e-3
    kw = dict(lr=lr, schedule=schedule, warmup_steps=2, total_steps=5)
    jinit, jstep = jmake_train_step(jm, JOptConfig(**kw), CTX, backend="jnp")
    jstep = jax.jit(jstep)
    tinit, tstep = make_train_step(tm, OptConfig(**kw))
    jopt, topt = jinit(jp), tinit(tp)
    src = SyntheticLM(512, 16, 2, seed=3)
    for step in range(3):
        batch = src.batch_at(step)
        jp, jopt, jmet = jstep(jp, jopt, batch, jnp.int32(step))
        tp, topt, tmet = tstep(tp, topt, batch, step)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=2e-3 if approx else 1e-5)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]),
                                   rtol=2e-3 if approx else 1e-4)
        np.testing.assert_allclose(tmet["lr"], float(jmet["lr"]), rtol=1e-6)
    want = load_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    for (path, w), g in zip(tree_items(want), tree_leaves(tp)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=2 * lr * 3, err_msg=str(path))


@pytest.mark.parametrize("schedule", ["cosine", "wsd", "constant"])
def test_schedules_match_reference(schedule):
    from repro.train.optimizer import make_schedule as jmake_schedule
    kw = dict(lr=3e-4, schedule=schedule, warmup_steps=10, total_steps=100)
    js, ts = jmake_schedule(JOptConfig(**kw)), make_schedule(OptConfig(**kw))
    for step in (0, 5, 9, 10, 50, 89, 90, 95, 99, 150):
        np.testing.assert_allclose(ts(step), float(js(jnp.int32(step))),
                                   rtol=1e-6)


def test_adafactor_steps_match_reference():
    jm, jp, tm, tp = _pair("h2o_danube_1_8b", False)
    kw = dict(name="adafactor", lr=1e-3, warmup_steps=1, total_steps=4)
    jinit, jstep = jmake_train_step(jm, JOptConfig(**kw), CTX, backend="jnp")
    tinit, tstep = make_train_step(tm, OptConfig(**kw))
    jopt, topt = jinit(jp), tinit(tp)
    src = SyntheticLM(512, 16, 2, seed=4)
    for step in range(2):
        jp, jopt, jmet = jax.jit(jstep)(jp, jopt, src.batch_at(step),
                                        jnp.int32(step))
        tp, topt, tmet = tstep(tp, topt, src.batch_at(step), step)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
    want = load_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    for (path, w), g in zip(tree_items(want), tree_leaves(tp)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=2 * 1e-3 * 2, err_msg=str(path))


# --------------------------------------------------------------------------
# convergence and accumulation (as tests/test_train_ckpt_data.py)
# --------------------------------------------------------------------------

def _tiny(approx=False):
    cfg = tget("yi_6b").reduced().with_(n_layers=2, d_model=64, d_ff=128,
                                        head_dim=16)
    return cfg.with_(approx=TRAPID) if approx else cfg


@pytest.mark.parametrize("approx,steps,drop", [(False, 40, 0.3),
                                               (True, 30, 0.2)])
def test_loss_decreases(approx, steps, drop):
    """Training converges, through the RAPID arithmetic too."""
    cfg = _tiny(approx)
    m = TModel(cfg)
    params = m.init(0, "cpu")
    init_opt, step = make_train_step(m, OptConfig(lr=3e-3, warmup_steps=5,
                                                  total_steps=60))
    opt = init_opt(params)
    src = SyntheticLM(cfg.vocab_size, 32, 8)
    losses = []
    for i in range(steps):
        params, opt, mt = step(params, opt, src.batch_at(i), i)
        losses.append(float(mt["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - drop, losses[::6]


def test_grad_accumulation_equivalent():
    cfg = _tiny()
    m = TModel(cfg)
    batch = SyntheticLM(cfg.vocab_size, 16, 8).batch_at(0)
    outs, losses = [], []
    for mb in (1, 4):
        params = m.init(0, "cpu")
        init_opt, step = make_train_step(m, OptConfig(lr=1e-3),
                                         microbatches=mb)
        p2, _, mt = step(params, init_opt(params), batch, 0)
        outs.append(tree_leaves(p2)[0].numpy().copy())
        losses.append(float(mt["loss"]))
    np.testing.assert_allclose(outs[0], outs[1], atol=3e-4, rtol=3e-3)
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)


def test_eval_step_equals_the_train_loss():
    cfg = _tiny()
    m = TModel(cfg)
    params = m.init(0, "cpu")
    batch = SyntheticLM(cfg.vocab_size, 16, 4).batch_at(2)
    ev = float(make_eval_step(m)(params, batch))
    init_opt, step = make_train_step(m, OptConfig())
    _, _, mt = step(params, init_opt(params), batch, 0)
    assert ev == float(mt["loss"])


# --------------------------------------------------------------------------
# checkpoints, the loop, data, compression
# --------------------------------------------------------------------------

def test_checkpoint_roundtrip_and_atomicity(tmp_path):
    cfg = _tiny()
    m = TModel(cfg)
    params = m.init(0, "cpu")
    opt = make_train_step(m, OptConfig())[0](params)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(5, params, opt, extra={"data_cursor": 5})
    mgr.save(10, params, opt)
    mgr.save(15, params, opt)
    assert sorted(mgr.all_steps()) == [10, 15]  # keep=2 pruned step 5
    assert not list(tmp_path.glob("*.tmp"))     # atomic: no temp dirs left
    other = m.init(9, "cpu")
    step, p2, o2, extra = mgr.restore(None, other, make_train_step(
        m, OptConfig())[0](other))
    assert step == 15
    for a, b in zip(tree_leaves(params), tree_leaves(p2)):
        assert torch.equal(a, b)
    # an interrupted write (a stale .tmp) is never restored from
    (tmp_path / "step_00000020.tmp").mkdir()
    assert mgr.latest_step() == 15


def test_checkpoint_layout_matches_reference(tmp_path):
    """The same params and AdamW state give the same files, with the
    same names, shapes and values, as the reference's checkpoint of its
    unstacked (``scan_layers=False``) tree."""
    jm, jp, tm, tp = _pair("h2o_danube_1_8b", False)
    jopt = jmake_train_step(jm, JOptConfig(), CTX)[0](jp)
    topt = make_train_step(tm, OptConfig())[0](tp)
    JCheckpointManager(str(tmp_path / "ref")).save(3, jp, jopt)
    CheckpointManager(str(tmp_path / "port")).save(3, tp, topt)
    rdir, pdir = tmp_path / "ref" / "step_00000003", \
        tmp_path / "port" / "step_00000003"
    names = sorted(p.name for p in rdir.iterdir())
    assert names == sorted(p.name for p in pdir.iterdir())
    rman = json.loads((rdir / "manifest.json").read_text())["arrays"]
    pman = json.loads((pdir / "manifest.json").read_text())["arrays"]
    assert rman == pman
    for name in names:
        if name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(pdir / name),
                                          np.load(rdir / name))


def test_loop_resume_continuity(tmp_path):
    cfg = _tiny()
    m = TModel(cfg)
    params = m.init(0, "cpu")
    init_opt, step = make_train_step(m, OptConfig(lr=1e-3))
    src = SyntheticLM(cfg.vocab_size, 16, 4)
    lc = LoopConfig(total_steps=6, ckpt_every=3, log_every=0,
                    ckpt_dir=str(tmp_path))
    st1 = train_loop(step, params, init_opt(params), src, lc)
    assert st1.step == 6 and len(st1.losses) == 6
    # "restart": fresh params, the loop resumes from the step-6 checkpoint
    params2 = m.init(9, "cpu")
    lc2 = LoopConfig(total_steps=10, ckpt_every=100, log_every=0,
                     ckpt_dir=str(tmp_path))
    st2 = train_loop(step, params2, init_opt(params2), src, lc2)
    assert st2.step == 10
    assert len(st2.losses) == 4  # steps 6..9 only: resumed, not restarted
    # and continuously: the same losses as one uninterrupted run
    params3 = m.init(0, "cpu")
    lc3 = LoopConfig(total_steps=10, ckpt_every=0, log_every=0,
                     ckpt_dir=str(tmp_path / "once"))
    st3 = train_loop(step, params3, init_opt(params3), src, lc3)
    np.testing.assert_allclose(st1.losses + st2.losses, st3.losses,
                               rtol=1e-6)


def test_loop_retries_a_loss_spike_once(tmp_path):
    cfg = _tiny()
    m = TModel(cfg)
    params = m.init(0, "cpu")
    init_opt, step = make_train_step(m, OptConfig(lr=1e-3))
    src = SyntheticLM(cfg.vocab_size, 16, 4)
    calls = []
    real = step.loss_and_grads

    def spiky(p, b):  # step 2's first attempt reports a spike
        loss, grads = real(p, b)
        calls.append(len(calls))
        return (loss * 100 if len(calls) == 3 else loss), grads

    step.loss_and_grads = spiky
    lc = LoopConfig(total_steps=4, ckpt_every=0, log_every=0,
                    ckpt_dir=str(tmp_path))
    st = train_loop(step, params, init_opt(params), src, lc)
    assert st.respun_steps == [2] and len(calls) == 5
    assert max(st.losses) < 50


def test_synthetic_batches_equal_the_reference():
    for vocab, seq, b, seed in ((512, 16, 4, 0), (32000, 128, 4, 7)):
        ours, ref = SyntheticLM(vocab, seq, b, seed), JSyntheticLM(vocab, seq,
                                                                   b, seed)
        for step in (0, 1, 42):
            got, want = ours.batch_at(step), ref.batch_at(step)
            for key in ("tokens", "targets"):
                assert got[key].dtype == want[key].dtype == np.int32
                np.testing.assert_array_equal(got[key], want[key])


def test_data_sources_and_host_slice(tmp_path):
    src = SyntheticLM(1000, 8, 16, seed=7)
    b1 = src.batch_at(42)
    parts = [host_slice(b1, i, 4)["tokens"] for i in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts), b1["tokens"])
    corpus = tmp_path / "toks.bin"
    np.arange(5000, dtype=np.uint16).tofile(corpus)
    cfg = _tiny()
    shape = {"seq_len": 32, "global_batch": 4}
    bins = make_source("bin", cfg, shape, seed=1, path=str(corpus))
    assert isinstance(bins, BinCorpus)
    from repro.data.pipeline import BinCorpus as JBinCorpus
    ref = JBinCorpus(str(corpus), cfg.vocab_size, 32, 4, seed=1)
    for step in (0, 3):
        np.testing.assert_array_equal(bins.batch_at(step)["tokens"],
                                      ref.batch_at(step)["tokens"])
    assert isinstance(make_source("synthetic", cfg, shape), SyntheticLM)
    with pytest.raises(ValueError):
        make_source("nope", cfg, shape)


def test_ef_compress_residual_bounded_and_matches_reference():
    rng = np.random.default_rng(0)
    grads = {"a": randn(rng, 64, 32), "blocks": [{"w": randn(rng, 16)}]}
    tg = {"a": T(grads["a"]), "blocks": [{"w": T(grads["blocks"][0]["w"])}]}
    res = ef_state(tg)
    jres = jax.tree.map(lambda g: jnp.zeros(g.shape, jnp.float32), grads)
    for _ in range(3):
        comp, res = ef_compress(tg, res)
        jcomp, jres = jef_compress(grads, jres)
        for (_, c), jc in zip(tree_items(comp), jax.tree.leaves(jcomp)):
            np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-6,
                                       atol=1e-7)
        for (_, r), (_, g) in zip(tree_items(res), tree_items(tg)):
            # the residual never exceeds half an int8 step of the target
            step = (g.abs().max() + r.abs().max()) / 127.0
            assert float(r.abs().max()) <= float(step) / 2 + 1e-6


def test_train_cli_on_cpu(tmp_path, capsys):
    from repro_torch.launch.train import main
    assert main(["--arch", "h2o_danube_1_8b", "--reduced", "--approx",
                 "--device", "cpu", "--steps", "2", "--batch", "2", "--seq",
                 "16", "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "final loss" in out and "nan" not in out
    assert CheckpointManager(str(tmp_path)).latest_step() == 2
