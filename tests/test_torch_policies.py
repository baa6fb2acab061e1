"""The port's cost laws and baseline policies against the JAX reference's,
on the CPU.

The reference evaluates ``delta_from_sigma``, ``step_time`` and
``step_energy`` in jnp float32 with weakly typed Python constants; the
port repeats each operation in numpy float32, powers through the scalar
``powf``. These hold bit-equality, and the policies' actions equal, over
a grid of observations: sigma 1 to 6 per owner, uniform and skewed
allocation weights, every window of the action space, and at each Eq. 7
threshold (delta_hat 1 and 6 ms) the two adjacent float32 sigmas whose
delta_hat falls either side of it: no float32 sigma maps to exactly 1.0
or 6.0 ms through the inverse, so these are the closest the rule can be
asked.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import controller as rctl
from repro.core import cost_model as rcm
from repro.core import dqn as rdqn
from repro.core import policies as rpol
from repro_torch.core import controller as pctl
from repro_torch.core import cost_model as pcm
from repro_torch.core import dqn as pdqn
from repro_torch.core import policies as ppol
from _jax_release import release_jax_executables  # noqa: F401

RP, PP = rcm.CostModelParams(), pcm.CostModelParams()
N_OWNERS = 3
KEY = jax.random.PRNGKey(0)


def _straddle(ms: float) -> tuple[np.float32, np.float32]:
    """The adjacent float32 sigmas (lo, hi) with delta_hat(lo) <= ms <
    delta_hat(hi), found by stepping ulps from the forward map."""
    s = np.float32(pcm.sigma_from_delta(PP, ms))
    while pcm.delta_from_sigma(PP, s) > np.float32(ms):
        s = np.nextafter(s, np.float32(0))
    while pcm.delta_from_sigma(PP, np.nextafter(s, np.float32(10))) \
            <= np.float32(ms):
        s = np.nextafter(s, np.float32(10))
    return s, np.nextafter(s, np.float32(10))


def _sigma_grid():
    """Per-owner sigma triples: a lattice over [1, 6], the sigma pairs
    straddling the Eq. 7 thresholds, and seeded noise."""
    vals = [np.float32(v) for v in (1.0, 1.05, 1.5, 2.0, 3.0, 4.5, 6.0)]
    for ms in (1.0, 6.0):
        vals += list(_straddle(ms))
    grid = [np.asarray([a, b, c], np.float32)
            for a in vals for b in vals[::3] for c in vals[::4]]
    rng = np.random.default_rng(3)
    grid += list((1 + 5 * rng.random((40, N_OWNERS))).astype(np.float32))
    return grid


SIGMAS = _sigma_grid()
WEIGHTS = [None, np.asarray([0.6, 0.2, 0.2], np.float32),
           np.asarray([0.1, 0.1, 0.8], np.float32)]


def _obs(sigma, rng):
    """A full observation vector whose first entries are ``sigma``."""
    rest = rng.random(rctl.state_dim(N_OWNERS) - N_OWNERS).astype(
        np.float32)
    return np.concatenate([sigma, rest]).astype(np.float32)


def _bits(a):
    return np.asarray(a, np.float32).tobytes()


@pytest.mark.parametrize("ms", [1.0, 6.0])
def test_thresholds_are_straddled_by_one_ulp(ms):
    """The threshold pair: one ulp of sigma apart, delta_hat either side
    of the threshold on both sides of the port, and the heuristic's
    window halves between them."""
    lo, hi = _straddle(ms)
    assert np.nextafter(lo, np.float32(10)) == hi
    pair = np.asarray([lo, hi], np.float32)
    for delta in (pcm.delta_from_sigma(PP, pair),
                  np.asarray(rcm.delta_from_sigma(RP, jnp.asarray(pair)))):
        assert delta[0] <= np.float32(ms) < delta[1]
    pol = ppol.heuristic_policy(PP, 16, N_OWNERS)
    a_lo = pol(np.asarray([lo, 1.0, 1.0], np.float32))
    a_hi = pol(np.asarray([1.0, hi, 1.0], np.float32))
    assert a_lo // (N_OWNERS + 1) == a_hi // (N_OWNERS + 1) + 1


def test_delta_from_sigma_bit_equal():
    sig = np.concatenate(SIGMAS).astype(np.float32)
    assert _bits(pcm.delta_from_sigma(PP, sig)) \
        == _bits(rcm.delta_from_sigma(RP, jnp.asarray(sig)))


@pytest.mark.parametrize("w_idx", range(len(pcm.WINDOW_CHOICES)))
def test_hit_rate_and_rebuild_time_bit_equal(w_idx):
    w = pcm.WINDOW_CHOICES[w_idx]
    assert _bits(pcm.hit_rate(PP, w)) == _bits(rcm.hit_rate(RP, w))
    assert _bits(pcm.rebuild_time(PP, w)) == _bits(rcm.rebuild_time(RP, w))


@pytest.mark.parametrize("wi", range(len(WEIGHTS)))
@pytest.mark.parametrize("w_idx", range(len(pcm.WINDOW_CHOICES)))
def test_step_time_and_energy_bit_equal(w_idx, wi):
    """Tolerance: none. Every (window, weights, sigma) of the grid gives
    the reference's float32 bits."""
    window = np.float32(pcm.WINDOW_CHOICES[w_idx])
    weights = WEIGHTS[wi]
    for sigma in SIGMAS:
        rw = None if weights is None else jnp.asarray(weights)
        assert _bits(pcm.step_time(PP, window, sigma, weights)) == _bits(
            rcm.step_time(RP, window, jnp.asarray(sigma), rw))
        assert _bits(pcm.step_energy(PP, window, sigma, weights)) == _bits(
            rcm.step_energy(RP, window, jnp.asarray(sigma), rw))
    assert _bits(pcm.allreduce_penalty(PP, SIGMAS[5])) == _bits(
        rcm.allreduce_penalty(RP, jnp.asarray(SIGMAS[5])))


def test_optimal_window_equal():
    for sigma in SIGMAS[::5]:
        rw, re = rcm.optimal_window(RP, jnp.asarray(sigma))
        pw, pe = pcm.optimal_window(PP, sigma)
        assert _bits(pw) == _bits(rw) and _bits(pe) == _bits(re)


@pytest.mark.parametrize("w0", [2, 8, 16, 64])
def test_heuristic_actions_equal(w0):
    ref = rpol.heuristic_policy(RP, w0, N_OWNERS)
    port = ppol.heuristic_policy(PP, w0, N_OWNERS)
    rng = np.random.default_rng(w0)
    seen = set()
    for sigma in SIGMAS:
        obs = _obs(sigma, rng)
        a = int(ref(jnp.asarray(obs), KEY))
        assert port(obs) == a, (w0, sigma)
        seen.add(a)
    choices = np.asarray(pcm.WINDOW_CHOICES)
    branches = {int(np.argmin(np.abs(choices - w)))
                for w in (w0, w0 // 2, w0 // 4)}
    assert len(seen) == len(branches)                  # every branch ran


@pytest.mark.parametrize("window", [1, 16, 128])
def test_static_actions_equal(window):
    ref = rpol.static_policy(window, N_OWNERS)
    port = ppol.static_policy(window, N_OWNERS)
    obs = _obs(SIGMAS[0], np.random.default_rng(0))
    assert port(obs) == int(ref(jnp.asarray(obs), KEY))


def test_oracle_actions_equal():
    ref = jax.jit(rpol.oracle_policy(RP, N_OWNERS))
    port = ppol.oracle_policy(PP, N_OWNERS)
    rng = np.random.default_rng(1)
    seen = set()
    for sigma in SIGMAS[::2]:
        obs = _obs(sigma, rng)
        a = int(ref(jnp.asarray(obs), KEY))
        assert port(obs) == a, sigma
        seen.add(a)
    assert len(seen) > 1


@pytest.fixture(scope="module")
def qnets(tmp_path_factory):
    qnet = rdqn.init_qnet(jax.random.PRNGKey(2), rctl.state_dim(N_OWNERS),
                          rctl.n_actions(N_OWNERS))
    path = str(tmp_path_factory.mktemp("qnet") / "qnet.npz")
    rdqn.save_qnet(path, qnet)
    return qnet, pdqn.load_qnet(path)


def test_dqn_policies_equal(qnets):
    rq, pq = qnets
    pairs = [(rpol.dqn_window_only_policy(rq, N_OWNERS),
              ppol.dqn_window_only_policy(pq, N_OWNERS)),
             (rpol.dqn_policy(rq), ppol.dqn_policy(pq))]
    rng = np.random.default_rng(4)
    for sigma in SIGMAS[::3]:
        obs = _obs(sigma, rng)
        for ref, port in pairs:
            assert port(obs) == int(ref(jnp.asarray(obs), KEY))
        assert ppol.dqn_window_only_policy(pq, N_OWNERS)(obs) \
            % (N_OWNERS + 1) == 0


def test_as_q_fn_drives_the_controller_to_the_policy_action():
    """``as_q_fn`` puts the policy's action at the argmax, as the
    reference's, and the controller decodes the same (W, weights)."""
    n_act = pctl.n_actions(N_OWNERS)
    port = ppol.as_q_fn(ppol.heuristic_policy(PP, 16, N_OWNERS), n_act)
    ref = rpol.as_q_fn(rpol.heuristic_policy(RP, 16, N_OWNERS), n_act)
    rng = np.random.default_rng(6)
    for sigma in SIGMAS[::7]:
        obs = _obs(sigma, rng)
        q = port(obs)
        assert q.dtype == np.float32
        np.testing.assert_array_equal(q, np.asarray(ref(obs)))
        w, ww = pctl.decode_action(int(np.argmax(q)), N_OWNERS)
        rw, rww = rctl.decode_action(int(np.argmax(q)), N_OWNERS)
        assert w == rw and _bits(ww) == _bits(rww)
