"""The port's serve engine against the JAX reference engine (CPU).

Greedy tokens must agree 100% per request (north-star rule 5), on the
reduced configs at float32 with the reference's params.  Sampled tokens
cannot match (torch has no ``fold_in``), so sampling is held to its
properties: deterministic for a seed, independent of batch mates.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs.base import RAPID as JRAPID  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.models.layers import ParallelCtx  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro_torch.configs.base import RAPID as TRAPID  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.models.params import load_jax_params  # noqa: E402
from repro_torch.serve.engine import ServeEngine as TEngine  # noqa: E402

PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8, 9], [10, 11, 12, 13, 14]]


def _engines(arch, approx, cache_n=32, **kw):
    jc = jget(arch).reduced().with_(dtype="float32")
    tc = tget(arch).reduced().with_(dtype="float32")
    if approx:
        jc, tc = jc.with_(approx=JRAPID), tc.with_(approx=TRAPID)
    jm = JModel(jc.with_backend("jnp"))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = load_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return (JEngine(jm, jp, ParallelCtx(), cache_n=cache_n, **kw),
            TEngine(TModel(tc), tp, cache_n=cache_n, **kw))


@pytest.mark.parametrize("arch,approx", [("h2o_danube_1_8b", True),
                                         ("minicpm_2b", True),
                                         ("minicpm_2b", False)])
def test_greedy_tokens_equal_reference(arch, approx):
    jeng, teng = _engines(arch, approx)
    ref = jeng.generate(PROMPTS, max_new=6)
    got = teng.generate(PROMPTS, max_new=6)
    assert got == ref


@pytest.fixture(scope="module")
def port_engine():
    cfg = tget("minicpm_2b").reduced().with_(dtype="float32", approx=TRAPID)
    model = TModel(cfg)
    return TEngine(model, model.init(0, "cpu"), cache_n=32)


def test_overflow_raises_value_error(port_engine):
    eng = TEngine(port_engine.model, port_engine.params, cache_n=16)
    with pytest.raises(ValueError, match=r"12.*8.*20.*16"):
        eng.generate([[1] * 12], max_new=8)


def test_stop_token_never_emitted(port_engine):
    free = port_engine.generate([[1, 2, 3]], max_new=6)[0]
    assert len(free) == 6
    # the stop token at its first occurrence in the free run
    for cut, stop in enumerate(free):
        if stop not in free[:cut]:
            out = port_engine.generate([[1, 2, 3]], max_new=6,
                                       stop_token=stop)[0]
            assert out == free[:cut] and stop not in out
    assert port_engine.generate([[1, 2, 3]], max_new=6,
                                stop_token=free[0])[0] == []


def test_sampling_deterministic_and_independent_of_batch_mates(port_engine):
    eng = TEngine(port_engine.model, port_engine.params, cache_n=32,
                  temperature=1.0, seed=7)
    a = eng.generate([[1, 2, 3], [4, 5, 6]], max_new=5)
    assert eng.generate([[1, 2, 3], [4, 5, 6]], max_new=5) == a
    # same request in the same slot, another batch mate of equal length
    b = eng.generate([[1, 2, 3], [9, 9, 9]], max_new=5)
    assert b[0] == a[0]
    other = TEngine(port_engine.model, port_engine.params, cache_n=32,
                    temperature=1.0, seed=8)
    assert other.generate([[1, 2, 3], [4, 5, 6]], max_new=5) != a
