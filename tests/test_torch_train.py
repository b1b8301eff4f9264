"""The port's training module against the JAX package's on the CPU, at
``tests/test_checkpoint.py``'s size (batch 2 x 256 points, grid 8, 64 and
16 samples), with parameters and optimizer states carried across.

The port's CrowdNet pools through ``sa_mlp_pool_trainable``, whose
backward is the JAX package's custom VJP (``maximum(x, 0)`` gives half the
gradient at 0); so its gradients are held against the JAX package's kernel
path (``use_pallas=True``, Pallas in interpret mode). The JAX package's
jnp path (``nn.relu``: no gradient at 0) differs from both in the set
abstractions' biases.

Tolerances: batches bit-equal. The first step's loss within 1e-6
relative and every gradient tensor within 1e-5 relative (norm of the
difference over the norm), sums in another order. One AdamW update from
the same state and gradients within 1e-6 relative plus 1e-4 of the
learning rate: the same formula rounded in another order (torch decays the
weight before the Adam step, optax adds both), and optax rounds the bias
correction 1 - 0.999^t to float32, 3e-5 relative at t = 2, where torch
keeps it in float64; the lr-0 first update is exact. After three steps, losses within 1e-4 relative and parameters within 2 x lr x steps
absolute: Adam turns a rounding difference in a near-zero gradient into an
update of up to lr. The served checkpoint's held-out metrics within 1e-4
relative. Remat, checkpoint resume and the npz round trip exact.
"""

import dataclasses

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lidar_ai_recommendation_software_tpu import neural as jneural
from lidar_ai_recommendation_software_tpu.models import train as jtrain
from lidar_ai_recommendation_software_tpu_torch import neural as tneural
from lidar_ai_recommendation_software_tpu_torch.models import train as ttrain

TINY = dict(batch_size=2, n_points=256, grid=8, sa1_samples=64,
            sa2_samples=16)
GRAD_TOL = 1e-5
STEPS = 3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_state(params, cfg):
    """A JAX TrainState over ``params`` with ``init_state``'s optimizer."""
    if cfg.lr_schedule_steps > 0:
        lr = optax.warmup_cosine_decay_schedule(
            0.0, cfg.learning_rate,
            warmup_steps=max(1, cfg.lr_schedule_steps // 20),
            decay_steps=cfg.lr_schedule_steps)
    else:
        lr = cfg.learning_rate
    return jtrain.TrainState.create(
        apply_fn=jtrain.make_model(cfg).apply,
        params=jax.tree_util.tree_map(jnp.asarray, params),
        tx=optax.adamw(lr, weight_decay=cfg.weight_decay))


@pytest.fixture(scope="module")
def carried():
    """The port's fresh state, the JAX package's state over the same
    parameters, the first batch, and both first-step gradients and
    losses."""
    tcfg = ttrain.TrainConfig(**TINY)
    jcfg = jtrain.TrainConfig(use_pallas=True, **TINY)
    state = ttrain.init_state(tcfg, device="cpu")
    params = ttrain.flax_from_params(state.model.state_dict())
    jstate = _jax_state(params, jcfg)
    batch = ttrain.make_batch(np.random.RandomState(tcfg.seed), tcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jmetrics), jgrads = jax.jit(
        jax.value_and_grad(jtrain.loss_fn, has_aux=True),
        static_argnums=(1, 3))(jstate.params, jstate.apply_fn, jbatch, jcfg)
    loss, metrics = ttrain.loss_fn(state.model,
                                   ttrain.batch_tensors(batch, "cpu"), tcfg)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in state.model.named_parameters()}
    return dict(tcfg=tcfg, jcfg=jcfg, state=state, params=params,
                jstate=jstate, batch=batch, jbatch=jbatch,
                loss=loss.detach(),
                metrics={k: v.detach() for k, v in metrics.items()}, grads=grads, jloss=jloss,
                jmetrics=jmetrics, jgrads=ttrain.params_from_flax(
                    _np(jgrads)))


@pytest.mark.parametrize("kw", [TINY, dict(TINY, speckle_prob=1.0,
                                           seed=5, grid=32),
                                dict(batch_size=1)],
                         ids=["tiny", "speckle", "default_width"])
def test_synth_example_and_make_batch_bit_equal(kw):
    tcfg, jcfg = ttrain.TrainConfig(**kw), jtrain.TrainConfig(**kw)
    trng, jrng = np.random.RandomState(3), np.random.RandomState(3)
    for _ in range(2):
        got, want = ttrain.make_batch(trng, tcfg), jtrain.make_batch(jrng,
                                                                     jcfg)
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["points"].shape == (tcfg.batch_size, tcfg.n_points, 3)
    one = ttrain.synth_example(np.random.RandomState(9), tcfg)
    ref = jtrain.synth_example(np.random.RandomState(9), jcfg)
    assert all(np.array_equal(one[k], ref[k]) for k in ref)


def test_loss_and_first_step_gradients_match_jax(carried):
    c = carried
    assert float(c["loss"]) == pytest.approx(float(c["jloss"]), rel=1e-6)
    for key in ("density_mae", "flow_mse", "count_rel_err"):
        assert float(c["metrics"][key]) == pytest.approx(
            float(c["jmetrics"][key]), rel=1e-6), key
    assert set(c["grads"]) == set(c["jgrads"])
    for name, g in c["grads"].items():
        want = c["jgrads"][name]
        assert g.shape == want.shape, name
        rel = float((g - want).norm() / want.norm())
        assert rel <= GRAD_TOL, (name, rel)
        assert float(want.norm()) > 0, name


def _carried_after_one_jax_step(cfg_kw):
    """From the same fresh parameters: the JAX state after one optax step,
    and the port's state carried from it (parameters, mu, nu, count)."""
    tcfg = ttrain.TrainConfig(**cfg_kw)
    jcfg = jtrain.TrainConfig(use_pallas=False, **cfg_kw)
    state = ttrain.init_state(tcfg, device="cpu")
    jstate = _jax_state(ttrain.flax_from_params(state.model.state_dict()),
                        jcfg)
    batch = {k: jnp.asarray(v) for k, v in ttrain.make_batch(
        np.random.RandomState(0), tcfg).items()}
    jstate, _ = jtrain.train_step(jstate, batch, jcfg)
    adam = jstate.opt_state[0]
    state.model.load_state_dict(ttrain.params_from_flax(_np(jstate.params)))
    state.optimizer.load_state_dict(ttrain.opt_state_from_optax(
        state, _np(adam.mu), _np(adam.nu), int(adam.count)))
    state.step = int(adam.count)
    return state, jstate, jcfg


@pytest.mark.parametrize("schedule", [0, 100], ids=["constant", "warmup"])
def test_adamw_update_matches_optax(schedule):
    kw = dict(TINY, lr_schedule_steps=schedule)
    state, jstate, _ = _carried_after_one_jax_step(kw)
    if schedule:  # the first update has lr 0, in optax and here
        cfg = ttrain.TrainConfig(**kw)
        fresh = ttrain.init_state(cfg, device="cpu")
        before = [p.detach().clone() for p in fresh.model.parameters()]
        ttrain.train_step(fresh, ttrain.batch_tensors(ttrain.make_batch(
            np.random.RandomState(0), cfg), "cpu"), cfg)
        for p, q, r in zip(state.model.parameters(),
                           fresh.model.parameters(), before):
            assert torch.equal(p, r) and torch.equal(q, r)
    rng = np.random.RandomState(1)
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.randn(*p.shape).astype(np.float32)
                              * 1e-2), jstate.params)
    want = ttrain.params_from_flax(_np(jstate.apply_gradients(
        grads=grads).params))
    tgrads = ttrain.params_from_flax(_np(grads))
    for name, p in state.model.named_parameters():
        p.grad = tgrads[name].clone()
    lr = state.schedule(state.step)
    assert lr > 0
    ttrain.apply_update(state)
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-6, atol=1e-4 * lr, err_msg=name)


def test_schedule_matches_optax():
    cfg = ttrain.TrainConfig(lr_schedule_steps=200)
    sched = ttrain.Schedule.of(cfg)
    want = optax.warmup_cosine_decay_schedule(
        0.0, cfg.learning_rate, warmup_steps=10, decay_steps=200)
    assert sched(0) == 0.0
    for count in (0, 1, 5, 9, 10, 11, 57, 199, 200, 260):
        assert sched(count) == pytest.approx(float(want(count)),
                                             rel=1e-6, abs=1.2e-7 * 3e-4), count
    assert ttrain.Schedule.of(ttrain.TrainConfig())(7) == 3e-4


def test_three_fit_steps_match_jax(carried):
    c = carried
    jcfg = c["jcfg"]
    jstate = _jax_state(c["params"], jcfg)  # train_step donates its state
    rng = np.random.RandomState(jcfg.seed)
    jlosses = []
    for _ in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in
                 jtrain.make_batch(rng, jcfg).items()}
        jstate, m = jtrain.train_step(jstate, batch, jcfg)
        jlosses.append(float(m["loss"]))
    state = ttrain.init_state(c["tcfg"], device="cpu")
    losses = []
    rng = np.random.RandomState(c["tcfg"].seed)
    for _ in range(STEPS):
        m = ttrain.train_step(state, ttrain.batch_tensors(
            ttrain.make_batch(rng, c["tcfg"]), "cpu"), c["tcfg"])
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses[0] == pytest.approx(jlosses[0], rel=1e-6)
    _, metrics = ttrain.fit(c["tcfg"], STEPS, log_every=0, device="cpu")
    assert metrics["loss"] == losses[-1]  # fit takes the same steps
    want = ttrain.params_from_flax(_np(jstate.params))
    atol = 2 * c["tcfg"].learning_rate * STEPS
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=atol, err_msg=name)


def test_remat_gradients_equal_the_plain_ones(carried):
    c = carried
    cfg = dataclasses.replace(c["tcfg"], remat=True)
    model = ttrain.make_model(cfg)
    model.load_state_dict(c["state"].model.state_dict())
    assert model.remat and not c["state"].model.remat
    loss, _ = ttrain.loss_fn(model, ttrain.batch_tensors(c["batch"], "cpu"),
                             cfg)
    loss.backward()
    assert torch.equal(loss.detach(), c["loss"])
    for name, p in model.named_parameters():
        assert torch.equal(p.grad, c["grads"][name]), name


def test_init_draws_what_flax_draws():
    """lecun_normal kernels (a normal truncated at 2 sigma, variance
    1 / fan-in, a convolution's fan-in in x kh x kw), zero biases,
    density_head's bias -3; the same seed gives the same weights."""
    cfg = ttrain.TrainConfig()
    model = ttrain.init_state(cfg, device="cpu").model
    shapes = {}
    for name, p in model.named_parameters():
        w = p.detach().numpy()
        if name.endswith("bias"):
            assert (w == (-3.0 if name == "density_head.bias" else 0.0)).all()
            continue
        fan_in = w.shape[0] if w.ndim == 2 else int(np.prod(w.shape[1:]))
        sigma = fan_in ** -0.5
        assert np.abs(w).max() <= 2 * sigma / 0.87962566103423978 + 1e-7
        if w.size >= 4096:
            assert w.std() == pytest.approx(sigma, rel=0.05), name
            assert abs(w.mean()) < 0.05 * sigma, name
        shapes[name] = w.shape
    assert shapes["bev.Conv_0.weight"] == (128, 201, 3, 3)
    assert shapes["sa2.mlp0_kernel"] == (67, 64)
    # the weights chip_smoke.py's recorded JAX losses start from
    assert ttrain.weights_digest(model.state_dict()) == \
        chip_smoke.JAX_REFERENCE_TRAIN["init_sha256"]
    again = ttrain.init_state(cfg, device="cpu").model.state_dict()
    other = ttrain.init_state(cfg, seed=1, device="cpu").model.state_dict()
    assert all(torch.equal(v, again[k]) for k, v in model.state_dict().items())
    assert not torch.equal(other["bev.Conv_0.weight"],
                           model.state_dict()["bev.Conv_0.weight"])


def test_evaluate_shipped_checkpoint_matches_jax():
    params, jcfg = jtrain.load_params_npz(jneural.default_checkpoint_path())
    tree, tcfg = ttrain.load_params_npz(tneural.default_checkpoint_path())
    want = jtrain.evaluate(params, jcfg, n_venues=2)
    got = ttrain.evaluate(ttrain.params_from_flax(tree), tcfg, n_venues=2,
                          device="cpu")
    assert set(got) == set(want)
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-4), key
    assert got["density_mae"] < got["density_mae_zero"]


def test_save_params_npz_is_read_and_served_by_jax(carried, tmp_path):
    c = carried
    state, _ = ttrain.fit(c["tcfg"], 1, log_every=0, device="cpu")
    path = str(tmp_path / "trained.npz")
    ttrain.save_params_npz(path, state.model.state_dict(), c["tcfg"])
    jparams, jcfg = jtrain.load_params_npz(path)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(c["tcfg"])
    back = ttrain.params_from_flax(_np(jparams))
    for name, p in state.model.state_dict().items():
        assert torch.equal(back[name], p), name
    tree, tcfg = ttrain.load_params_npz(path)
    assert tcfg == c["tcfg"]
    assert jax.tree_util.tree_structure(jparams) == \
        jax.tree_util.tree_structure(c["jstate"].params)
    b = c["batch"]
    out = jtrain.make_model(jtrain.TrainConfig(**TINY)).apply(
        {"params": jparams}, *(jnp.asarray(b[k]) for k in
                               ("points", "mask", "venue_min",
                                "venue_size")))
    with torch.no_grad():
        got = state.model.eval()(*(torch.from_numpy(b[k]) for k in
                                   ("points", "mask", "venue_min",
                                    "venue_size")))
    for key in got:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(out[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


def _same_state(a, b):
    for (n, p), q in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(p, q), n
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    for i in sa["state"]:
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa["state"][i][key], sb["state"][i][key])
    assert a.step == b.step and a.schedule == b.schedule


def test_checkpoint_resume_is_bit_equal(carried, tmp_path):
    """2 steps, save, restore, 1 step: bit-equal to three straight steps
    on batches 0, 1 and 0, because ``fit`` restarts its batch stream from
    ``RandomState(cfg.seed)`` on resume, as the JAX package's does."""
    cfg = dataclasses.replace(carried["tcfg"], lr_schedule_steps=40)
    state, _ = ttrain.fit(cfg, 2, log_every=0, device="cpu")
    path = str(tmp_path / "state.pt")
    ttrain.save_checkpoint(path, state, cfg)
    restored = ttrain.restore_checkpoint(path, cfg, device="cpu")
    _same_state(state, restored)
    resumed, _ = ttrain.fit(cfg, 1, state=restored, log_every=0)
    assert resumed.step == 3

    rng = np.random.RandomState(cfg.seed)
    batches = [ttrain.batch_tensors(ttrain.make_batch(rng, cfg), "cpu")
               for _ in range(3)]
    straight = ttrain.init_state(cfg, device="cpu")
    for i in (0, 1, 0):
        ttrain.train_step(straight, batches[i], cfg)
    _same_state(resumed, straight)
    three, _ = ttrain.fit(cfg, 3, log_every=0, device="cpu")
    assert not torch.equal(three.model.bev.Conv_0.weight,
                           resumed.model.bev.Conv_0.weight)
    with pytest.raises(ValueError, match="another TrainConfig"):
        ttrain.restore_checkpoint(path, carried["tcfg"], device="cpu")


def test_entry_points_need_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = ttrain.TrainConfig(**TINY)
    for call in (lambda: ttrain.init_state(cfg),
                 lambda: ttrain.fit(cfg, 1),
                 lambda: ttrain.evaluate({}, cfg),
                 lambda: ttrain.restore_checkpoint("missing.pt", cfg)):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            call()
