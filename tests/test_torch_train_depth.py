"""Training xlstm_350m at its full depth against the JAX reference (CPU,
plain torch).

The card trains the whole model (24 layers, sLSTM at 5, 13 and 21) on
4 x 128 tokens; here the same depth, layout and batch shape at the
reduced width (d 128, vocab 512), f32, EXACT, remat off, the reference's
seeded init (``PRNGKey(0)``), ``SyntheticLM`` seed 0.  The reference arm
is the jitted ``jnp`` backend.

At this depth the gradient at init is chaotic: the residual stream
entering layer 23 moves by ~3e-3 of its largest, the cotangents by
10-50% and the gradient norm (~1.1e4, against 78.9 for two full-width
layers, ``tests/test_torch_train_width.py``) by ~2% when the reference's
own embedding moves by one ulp.  So the port is held as the reference is
held against itself (measured in brackets):

* the loss within rtol 1e-5 (the dense family's) [4.2e-6];
* each of the 24 mixers' VJP on the reference's own input and output
  cotangent within 1e-4 x each leaf's largest (the dense family's)
  [4.3e-6, layer 7's wf]: the backward at depth, given the same inputs;
* the whole gradient's norm and its largest leaf (the embedding) no
  further from the reference's than SPREAD times the reference's own
  distance from itself with its embedding moved by one ulp (each element
  up, down or kept, seeded) [norm 4.9e-2 against 1.8e-2, the embedding
  1.4e-1 against 8.7e-2].
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_xlstm as tx  # noqa: E402
from test_torch_train_recurrent import _grad_leaves, record_mixers  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
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
OVER = dict(n_layers=24, slstm_at=(5, 13, 21), remat="none", dtype="float32")
SPREAD = 4.0


def _one_ulp(a: np.ndarray, seed: int) -> np.ndarray:
    """``a`` (f32) with each element moved one ulp up, one down or kept."""
    u = np.random.default_rng(seed).integers(-1, 2, size=a.shape)
    return np.where(u > 0, np.nextafter(a, np.float32(np.inf)),
                    np.where(u < 0, np.nextafter(a, np.float32(-np.inf)),
                             a)).astype(np.float32)


def _rel(a, w) -> float:
    a, w = np.asarray(a, np.float64), np.asarray(w, np.float64)
    return float(np.abs(a - w).max() / np.abs(w).max())


def _norm(leaves) -> float:
    return float(np.sqrt(sum(float((np.asarray(g, np.float64) ** 2).sum())
                             for g in leaves)))


def test_full_depth_grads_against_the_reference_and_its_spread():
    jc = jget(tx.ARCH).reduced().with_(**OVER).with_backend("jnp")
    tc = tget(tx.ARCH).reduced().with_(**OVER)
    jm, tm = JModel(jc), TModel(tc)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    jp = jax.tree.map(jnp.asarray, tree)
    batch = SyntheticLM(tc.vocab_size, 128, 4, seed=0).batch_at(0)
    jl, jg, calls = record_mixers(jm, jp, batch)
    moved = dict(jp, embed=jnp.asarray(_one_ulp(tree["embed"], 0)))
    _, jg_moved, _ = record_mixers(jm, moved, batch)

    tp = load_jax_params(tree, device="cpu")
    vjps = {kind: jax.jit(lambda x, p, ct, f=getattr(jxl, kind): jax.vjp(
        lambda x, p: f(x, p, jc, CTX)[0], x, p)[1](ct))
        for kind in ("mlstm", "slstm")}
    for i, (kind, x, ct) in enumerate(calls):
        lp = tp["blocks"][i][kind]
        names = sorted(lp)
        rx, rp = vjps[kind](jnp.asarray(x), jp["blocks"][f"l{i}"][kind],
                            jnp.asarray(ct))
        xt = T(x.copy()).requires_grad_(True)
        leaves = [lp[n].detach().clone().requires_grad_(True) for n in names]
        got = torch.autograd.grad(
            getattr(txl, kind)(xt, dict(zip(names, leaves)), tc)[0],
            [xt] + leaves, T(ct.copy()))
        ref = [rx] + [rp[n] for n in names]
        worst = max((_rel(g.numpy(), w), n)
                    for n, g, w in zip(["input"] + names, got, ref))
        print(f"layer {i} {kind}: VJP on the reference's inputs, worst "
              f"{worst[0]:.2e} ({worst[1]})")
        assert worst[0] <= 1e-4, (i, worst)

    loss, grads = _grad_leaves(tm, tp, batch)
    np.testing.assert_allclose(loss, float(jl), rtol=1e-5)
    want, spread = (jax.tree.map(np.asarray, g) for g in (jg, jg_moved))
    norm, ref_norm = _norm(g.numpy() for g in grads), _norm(
        jax.tree.leaves(want))
    own = abs(_norm(jax.tree.leaves(spread)) - ref_norm) / ref_norm
    port = abs(norm - ref_norm) / ref_norm
    embed = grads[[p for p, _ in tree_items(tp)].index(("embed",))]
    own_e = _rel(spread["embed"], want["embed"])
    port_e = _rel(embed.numpy(), want["embed"])
    print(f"24 layers: loss {loss!r} vs {float(jl)!r}; gradient norm "
          f"{norm!r} vs the reference's {ref_norm!r} ({port:.2e}; the "
          f"reference with its embedding one ulp off: {own:.2e}); the "
          f"embedding's gradient {port_e:.2e} off (the reference's own "
          f"{own_e:.2e})")
    assert port <= SPREAD * own and port_e <= SPREAD * own_e
