"""Training xlstm_350m at its full width against the JAX reference (CPU,
plain torch).

The card trains the whole model (24 layers); here, where a full-size
model is not traced, a 2-layer copy at the full width: d 1024, mLSTM
heads of 512 in the 2048-wide up-projected space, sLSTM heads of 256,
the full vocabulary of 50304; layer 0 an mLSTM and layer 1 an sLSTM (the
kinds of the card's layers 4 and 5).  f32, remat off, the reference's
seeded init (``PRNGKey(0)``), one sequence of 32 tokens (``SyntheticLM``
seed 1).  The reference arm is the jitted ``jnp`` backend with its
weight matmuls summed one k at a time (``chunk1``, as in
``tests/test_torch_train_recurrent.py``).

Tolerances, each with its reason (measured worst cases in brackets):

* EXACT, against ``jax.value_and_grad`` of ``Model.loss_fn``: the loss
  within rtol 1e-5, the gradient norm within rtol 1e-4 and every
  gradient leaf within 1e-4 x its largest (the dense family's bounds)
  [loss 1.7e-7, norm 4.3e-6, leaves 5.8e-5 at layer 0's wv];
* RAPID: the loss within rtol 2e-3 and the gradient norm within rtol
  GNORM_RAPID 5e-3 [loss 5.0e-5, norm 1.5e-3]; every gradient leaf
  within DRIFT_GRAD 5e-2 x its largest [2.6e-2, the sLSTM's r]: the
  forward drifts by RAPID cell edges (ROADMAP §3: a one-ulp operand
  difference moves a K1 operand across an edge of its coefficient cell),
  the stream entering layer 1 6.2e-4 of its largest off, the last 1.6e-3,
  and r's gradient sums 32 steps' outer products of that drifted state;
* each mixer's output and VJP on the reference's own input and output
  cotangent (recorded inside the reference's gradient): the output, the
  input's and every leaf's gradient within MIXER_VJP x its largest,
  EXACT 1e-4, RAPID 5e-3 (the dense family's) [EXACT 2.5e-5, layer 0's
  input; RAPID 1.8e-4, the sLSTM's output, whose K1 / K6 operands one
  ulp apart land in other coefficient cells]: the backward at full width
  given the same inputs, apart from the forward's drift.
"""
from functools import lru_cache, partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_xlstm as tx  # noqa: E402
from test_torch_train_recurrent import _grad_leaves, record_mixers  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.core import ops as jops  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import xlstm as jxl  # noqa: E402
from repro.models.layers import ParallelCtx  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.models import xlstm as txl  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.models.params import load_jax_params, tree_items  # noqa: E402

CTX = ParallelCtx()
T = torch.from_numpy
OVER = dict(n_layers=2, slstm_at=(1,), remat="none", dtype="float32")
GNORM_RAPID = 5e-3
DRIFT_GRAD = 5e-2
MIXER_VJP = {False: 1e-4, True: 5e-3}


@pytest.fixture(scope="module", autouse=True)
def chunk1():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlayers, "qmatmul", partial(jops.qmatmul, chunk=1))
        yield


@lru_cache(maxsize=None)
def _tree():
    return jax.tree.map(np.asarray, JModel(
        jget(tx.ARCH).with_(**OVER).with_backend("jnp")).init(
            jax.random.PRNGKey(0)))


def _pair(approx):
    jc, tc = jget(tx.ARCH).with_(**OVER), tget(tx.ARCH).with_(**OVER)
    if approx:
        jc, tc = jc.with_(approx=tx.JRAPID), tc.with_(approx=tx.TRAPID)
    assert (tc.d_model, tc.n_heads, tc.vocab_size) == (1024, 4, 50304)
    return (JModel(jc.with_backend("jnp")), jax.tree.map(jnp.asarray, _tree()),
            TModel(tc), load_jax_params(_tree(), device="cpu"))


def _batch():
    return SyntheticLM(50304, 32, 1, seed=1).batch_at(0)


@lru_cache(maxsize=None)
def _reference(approx):
    """The reference's loss, gradients (the port's tree) and mixer calls
    (:func:`record_mixers`) on the batch; once an arithmetic."""
    jm, jp, _, _ = _pair(approx)
    loss, grads, calls = record_mixers(jm, jp, _batch())
    return float(loss), load_jax_params(jax.tree.map(np.asarray, grads),
                                        device="cpu"), calls


def _norm(leaves) -> float:
    return float(np.sqrt(sum(float((g.double() ** 2).sum()) for g in leaves)))


@pytest.mark.parametrize("approx", [False, True], ids=["exact", "rapid"])
def test_full_width_loss_and_grads_match_reference(approx):
    _, _, tm, tp = _pair(approx)
    jl, want, _ = _reference(approx)
    loss, grads = _grad_leaves(tm, tp, _batch())
    norm, ref_norm = _norm(grads), _norm(w for _, w in tree_items(want))
    worst = (0.0, None)
    for (path, w), g in zip(tree_items(want), grads):
        worst = max(worst, (float((g - w).abs().max())
                            / float(w.abs().max()), str(path)))
    print(f"full width {'RAPID' if approx else 'EXACT'}: loss {loss!r} vs "
          f"{float(jl)!r}; gradient norm {norm!r} vs the reference's "
          f"{ref_norm!r}; worst leaf {worst[0]:.2e} ({worst[1]})")
    np.testing.assert_allclose(loss, float(jl), rtol=2e-3 if approx else 1e-5)
    np.testing.assert_allclose(norm, ref_norm,
                               rtol=GNORM_RAPID if approx else 1e-4)
    assert worst[0] <= (DRIFT_GRAD if approx else 1e-4), worst


@pytest.mark.parametrize("approx", [False, True], ids=["exact", "rapid"])
def test_full_width_mixer_vjps_on_the_reference_inputs(approx):
    jm, jp, tm, tp = _pair(approx)
    for i, (kind, x, ct) in enumerate(_reference(approx)[2]):
        lp = tp["blocks"][i][kind]
        names = sorted(lp)
        rout, vjp = jax.vjp(lambda x, p: getattr(jxl, kind)(
            x, p, jm.cfg, CTX)[0], jnp.asarray(x), jp["blocks"][f"l{i}"][kind])
        rx, rp = vjp(jnp.asarray(ct))
        ref = [np.asarray(rout), np.asarray(rx)] + [np.asarray(rp[n])
                                                    for n in names]
        xt = T(x.copy()).requires_grad_(True)
        leaves = [lp[n].detach().clone().requires_grad_(True) for n in names]
        out = getattr(txl, kind)(xt, dict(zip(names, leaves)), tm.cfg)[0]
        got = [out.detach()] + list(torch.autograd.grad(
            out, [xt] + leaves, T(ct.copy())))
        for n, g, w in zip(["output", "input"] + names, got, ref):
            rel = float(np.abs(g.numpy() - w).max() / np.abs(w).max())
            print(f"layer {i} {kind} {n}: {rel:.2e} of its largest")
            assert rel <= MIXER_VJP[approx], (i, n)
