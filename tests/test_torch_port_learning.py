"""PyTorch port: the learning loop (learning/{data,train}.py, the module's
training mode, the trained-weights asset) against the JAX package on the
CPU.

Tolerances, with their reasons:
- datasets: exact (the same numpy code on the same CSV values);
- the schedule and the clip: rtol 1e-14 (one f64 cos or sqrt apart);
- training steps in f64 on both sides (x64, flax params cast to f64,
  compute_dtype f64, f64 data), dropout 0, the same initial weights and
  batch indices: per-step losses rtol 1e-10, parameters rtol 1e-8 / atol
  1e-12 after 5 steps (only the order of f64 sums differs; both modules
  cast their output to f32, identically for outputs that agree to 1e-15);
  one f32 case: losses rtol 1e-4;
- the trained-weights file: bit for bit against the orbax restore, its
  forward against flax apply at 2e-5 (tests/test_estimator_kernel.py:44).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from humanoid_mppi_rl_tpu.learning import data as jdata
from humanoid_mppi_rl_tpu.learning import train as jtrain
from humanoid_mppi_rl_tpu.learning.torch_import import feature_attention_params
from humanoid_mppi_rl_tpu.models.predictors import make_model as jax_make_model
from humanoid_mppi_rl_tpu_torch.learning import data as pdata
from humanoid_mppi_rl_tpu_torch.learning import train as ptrain
from humanoid_mppi_rl_tpu_torch.models.convert import (
    load_trained, params_from_flax, trained_path)
from humanoid_mppi_rl_tpu_torch.models.predictors import make_model

# One intra-op thread: the suite runs in several worker processes on shared
# cores, and PyTorch's default of a thread per core in each of them
# oversubscribes the cores (one trainer test took 35x longer, six at once).
torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _write_dirs(root, lengths, sdim, adim, seed, linear=False):
    """states/ and actions/ CSV dirs, one trajectory per length (np.savetxt,
    as the JAX tests write them). `linear`: x' = A x + B u, else noise; the
    last trajectory's actions are one row longer than its states."""
    rng = np.random.default_rng(seed)
    sdir, adir = root / "states", root / "actions"
    sdir.mkdir()
    adir.mkdir()
    A = np.eye(sdim) + 0.05 * rng.normal(size=(sdim, sdim))
    B = 0.1 * rng.normal(size=(sdim, adim))
    for i, n in enumerate(lengths):
        us = rng.normal(size=(n + (i == len(lengths) - 1), adim))
        if linear:
            x, xs = rng.normal(size=sdim), []
            for t in range(n):
                xs.append(x.copy())
                x = A @ x + B @ us[t]
            xs = np.stack(xs)
        else:
            xs = rng.normal(size=(n, sdim)).cumsum(axis=0)
        np.savetxt(sdir / f"traj{i}.csv", xs, delimiter=",")
        np.savetxt(adir / f"traj{i}.csv", us, delimiter=",")
    return str(sdir), str(adir)


@pytest.fixture(scope="module")
def ragged_dirs(tmp_path_factory):
    """Five trajectories: one of a single row (skipped), one of 3 rows
    (pairs but no 3-step windows), three longer ones."""
    return _write_dirs(tmp_path_factory.mktemp("ragged"), [40, 1, 3, 57, 25], 6, 2, seed=3)


@pytest.fixture(scope="module")
def toy_dirs(tmp_path_factory):
    """tests/test_learning.py's toy problem: linear dynamics, 4 x 60 rows."""
    return _write_dirs(tmp_path_factory.mktemp("toy"), [60] * 4, 4, 1, seed=0, linear=True)


DATASET_CASES = {
    "delta_windows_noise": dict(return_type="delta", eval_split=0.2, rollout_k=3,
                                state_idxes=(0, 2, 3, 5), noise_std=0.05, seed=7),
    "pct_sequential_normalized": dict(return_type="pct", split="sequential", normalize=True,
                                      smooth_window=3, eval_split=0.25),
    "raw_no_eval": dict(return_type="raw", eval_split=0.0, state_idxes=(1, 4)),
}


def _dataset_arrays(ds):
    names = ("inputs", "targets", "train_idx", "eval_idx", "mean", "std", "win_states",
             "win_actions", "win_train_idx", "win_eval_idx")
    return {n: getattr(ds, n, None) for n in names}


def _batches(ds):
    return [list(ds.batches(16, train=True, seed=3)),
            list(ds.batches(16, train=False, drop_remainder=False))]


@pytest.mark.parametrize("case", sorted(DATASET_CASES))
def test_multi_trajectory_dataset_matches_jax(ragged_dirs, case):
    kw = DATASET_CASES[case]
    want = jdata.MultiTrajectoryDataset(*ragged_dirs, **kw)
    got = pdata.MultiTrajectoryDataset(*ragged_dirs, **kw)
    for name, a in _dataset_arrays(want).items():
        b = _dataset_arrays(got)[name]
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(b, a, err_msg=name)
    assert got.sanity_check() == want.sanity_check()
    assert len(_batches(got)[0]) > 0
    for bw, bg in zip(_batches(want), _batches(got)):
        assert len(bw) == len(bg)
        for (xw, yw), (xg, yg) in zip(bw, bg):
            np.testing.assert_array_equal(xg, xw)
            np.testing.assert_array_equal(yg, yw)


def test_state_action_dataset_matches_jax(ragged_dirs):
    s, a = (os.path.join(d, "traj3.csv") for d in ragged_dirs)
    kw = dict(return_type="pct", normalize=True, smooth_window=4, noise_std=0.1,
              state_idxes=(0, 1, 5), seed=2)
    want, got = jdata.StateActionDataset(s, a, **kw), pdata.StateActionDataset(s, a, **kw)
    for name in ("inputs", "targets", "train_idx", "eval_idx", "mean", "std"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    for (xw, yw), (xg, yg) in zip(want.batches(8, seed=5), got.batches(8, seed=5)):
        np.testing.assert_array_equal(xg, xw)
        np.testing.assert_array_equal(yg, yw)


def test_dataset_errors_match_jax(tmp_path, ragged_dirs):
    with pytest.raises(ValueError, match="delta"):
        pdata.MultiTrajectoryDataset(*ragged_dirs, return_type="raw", rollout_k=3)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(ValueError, match="no trajectories"):
        pdata.MultiTrajectoryDataset(str(empty), str(empty))


# ---- optimizer pieces ------------------------------------------------------

def test_schedule_matches_optax():
    """The learning rate at the step count before each update: the factor
    alone, and through create_train_state's Adam + LambdaLR."""
    lr, n, alpha = 1e-4, 40, 1e-6 / 1e-4
    sched = optax.cosine_decay_schedule(lr, n, alpha=alpha)
    for count in (0, 1, n // 2, n - 1, n, n + 7):
        np.testing.assert_allclose(lr * ptrain.cosine_decay(count, n, alpha),
                                   float(sched(count)), rtol=1e-14)
    cfg = ptrain.TrainConfig(model_preset="cartpole_attention", lr=lr, epochs=4,
                             model_overrides=dict(hidden_dim=8))
    model, state = ptrain.create_train_state(cfg, np.zeros((1, 5)), n // 4, device="cpu")
    for count in range(n + 3):
        assert state.step == count
        np.testing.assert_allclose(state.optimizer.param_groups[0]["lr"], float(sched(count)),
                                   rtol=1e-14)
        model(torch.ones(2, 5)).sum().backward()
        state.apply_gradients()


@pytest.mark.parametrize("max_norm", [0.5, 50.0])
def test_clip_matches_optax(max_norm):
    """The norm of the grads below is ~6.8: clipped at 0.5, left at 50."""
    rng = np.random.default_rng(0)
    grads = [rng.normal(size=s) for s in [(3, 4), (5,), (2, 2, 2)]]
    clip = optax.clip_by_global_norm(max_norm)
    want, _ = clip.update([jnp.asarray(g) for g in grads], clip.init(grads))
    got = [torch.tensor(g) for g in grads]
    norm = ptrain.clip_by_global_norm_(got, max_norm)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)), rtol=1e-14)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-14, atol=0)
    assert (max_norm > float(norm)) == all(
        np.array_equal(g.numpy(), h) for g, h in zip(got, grads))


# ---- training steps against the JAX trainer --------------------------------

# (preset, overrides): cartpole's width, and the quadruped's shape narrowed
SHAPES = {"cartpole": ("cartpole_attention", dict()),
          "quadruped": ("quadruped_attention", dict(state_dim=19, hidden_dim=32))}
N_STEPS, BATCH, K_ROLL = 5, 8, 3


def _pair(shape, dtype, grad_clip):
    """(JAX model, JAX state, port model, port state): the same f32-drawn
    initial weights in `dtype` on both sides, dropout 0."""
    preset, over = SHAPES[shape]
    over = dict(over, dropout_rate=0.0)
    jdt, tdt = {"float64": (jnp.float64, torch.float64),
                "float32": (jnp.float32, torch.float32)}[dtype]
    lr = 1e-4
    jcfg = jtrain.TrainConfig(model_preset=preset, lr=lr, epochs=2, compute_dtype=jdt,
                              model_overrides=over, grad_clip=grad_clip)
    pcfg = ptrain.TrainConfig(model_preset=preset, lr=lr, epochs=2, compute_dtype=tdt,
                              model_overrides=over, grad_clip=grad_clip)
    jm = jax_make_model(preset, **over)
    x0 = np.zeros((1, jm.state_dim + jm.action_dim), np.float32)
    model, jstate = jtrain.create_train_state(jcfg, x0, N_STEPS)
    p32 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jstate.params)
    jstate = jtrain.TrainState.create(
        apply_fn=model.apply, params=jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), p32),
        tx=jstate.tx)
    pmodel, pstate = ptrain.create_train_state(pcfg, x0, N_STEPS, device="cpu")
    pmodel.load_state_dict(params_from_flax(p32, pmodel))
    assert next(pmodel.parameters()).dtype == tdt
    return model, jstate, pmodel, pstate


def _port_params_as_flax(pmodel):
    sd = {k: v.detach().numpy() for k, v in pmodel.state_dict().items()}
    return feature_attention_params(sd, pmodel.num_heads, pmodel.attn_layers)


def _assert_params(pmodel, jparams, rtol, atol):
    """Every leaf at rtol/atol, except the attention key biases: softmax is
    invariant to them, so their exact gradient is 0 and each side's is
    rounding noise (~1e-17), which Adam divides by |g| + 1e-8. Those stay
    at their initial 0 within 5 steps x lr x 1e-7 on both sides instead."""
    got = dict(jax.tree_util.tree_leaves_with_path(_port_params_as_flax(pmodel)))
    want = jax.tree_util.tree_leaves_with_path(jparams["params"])
    assert len(got) == len(want)
    for path, w in want:
        name = jax.tree_util.keystr(path)
        if "['key']['bias']" in name:
            bound = N_STEPS * 1e-4 * 1e-7
            assert np.abs(got[path]).max() < bound and np.abs(np.asarray(w)).max() < bound, name
            continue
        np.testing.assert_allclose(got[path], np.asarray(w), rtol=rtol, atol=atol, err_msg=name)


def _data(kind, pmodel, dtype, seed=0):
    rng = np.random.default_rng(seed)
    Sd, Ad = pmodel.state_dim, pmodel.action_dim
    if kind == "pairs":
        N = 64
        arrays = (rng.normal(size=(N, Sd + Ad)), 0.1 * rng.normal(size=(N, Sd)))
    else:
        N = 48
        s = np.cumsum(0.05 * rng.normal(size=(N, K_ROLL + 1, Sd)), axis=1)
        s += rng.normal(size=(N, 1, Sd))
        s[..., :2] += 3.0   # absolute root x/y, zeroed in the net input
        arrays = (s, rng.normal(size=(N, K_ROLL, Ad)))
    perm = rng.permutation(N)
    train_idx = perm[: N_STEPS * BATCH].reshape(N_STEPS, BATCH)
    eval_idx = perm[N_STEPS * BATCH:][: 1 * BATCH].reshape(1, BATCH)
    arrays = tuple(a.astype(dtype) for a in arrays)
    return arrays, train_idx.astype(np.int32), eval_idx.astype(np.int32)


def _makers(kind, model):
    if kind == "pairs":
        return (lambda *a: jtrain.make_scanned_steps(model.apply, *a),
                lambda *a: ptrain.make_scanned_steps(*a))
    return (lambda *a: jtrain.make_scanned_rollout_steps(model.apply, *a, K_ROLL,
                                                         ego_cols=(0, 1)),
            lambda *a: ptrain.make_scanned_rollout_steps(*a, K_ROLL, ego_cols=(0, 1)))


def _run_steps(shape, kind, dtype):
    """N_STEPS single-batch scanned epochs on both sides: per-step losses,
    the final states and both eval tuples."""
    grad_clip = 1.0 if kind == "rollout" else 0.0
    model, jstate, pmodel, pstate = _pair(shape, dtype, grad_clip)
    arrays, train_idx, eval_idx = _data(kind, pmodel, dtype)
    jmake, pmake = _makers(kind, model)
    jtrain_epoch, jeval = jmake(*(jnp.asarray(a) for a in arrays))
    ptrain_epoch, peval = pmake(*(torch.from_numpy(a) for a in arrays))
    gen = torch.Generator()
    jl, pl = [], []
    for i in range(N_STEPS):
        jstate, loss = jtrain_epoch(jstate, jnp.asarray(train_idx[i:i + 1]),
                                    jax.random.PRNGKey(i))
        jl.append(float(loss))
        pstate, loss = ptrain_epoch(pstate, torch.from_numpy(train_idx[i:i + 1]).long(), gen)
        pl.append(float(loss))
    assert pstate.step == int(jstate.step) == N_STEPS
    jev = [np.asarray(a) for a in jeval(jstate.params, jnp.asarray(eval_idx))]
    pev = [t.numpy() for t in peval(pmodel, torch.from_numpy(eval_idx).long())]
    return np.array(jl), np.array(pl), jstate, pmodel, jev, pev


@pytest.mark.parametrize("kind", ["pairs", "rollout"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_scanned_steps_match_jax_f64(shape, kind):
    """make_scanned_steps, and make_scanned_rollout_steps (k=3, ego cols
    (0, 1), grad_clip 1.0), over 5 steps in f64."""
    jl, pl, jstate, pmodel, jev, pev = _run_steps(shape, kind, "float64")
    assert np.all(np.isfinite(jl)) and jl[-1] != jl[0]
    np.testing.assert_allclose(pl, jl, rtol=1e-10)
    _assert_params(pmodel, jstate.params, rtol=1e-8, atol=1e-12)
    for g, w in zip(pev, jev):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-14)


def test_scanned_rollout_steps_match_jax_f32():
    jl, pl, jstate, pmodel, jev, pev = _run_steps("quadruped", "rollout", "float32")
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    for g, w in zip(pev, jev):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)


def test_clip_engages_in_the_rollout_steps():
    """The f64 rollout case above runs with grad_clip 1.0: its first
    gradient's norm is above 1, so the clip is in play there."""
    model, jstate, pmodel, pstate = _pair("quadruped", "float64", 0.0)
    arrays, train_idx, _ = _data("rollout", pmodel, "float64")
    S, A = (torch.from_numpy(a) for a in arrays)
    b = torch.from_numpy(train_idx[0]).long()
    x = S[b, 0]
    tot = 0.0
    for j in range(K_ROLL):
        x = x + pmodel.train()(torch.cat([x.index_fill(-1, torch.tensor([0, 1]), 0.0),
                                          A[b, j]], -1))
        tot = tot + torch.mean((x - S[b, j + 1]) ** 2)
    (tot / K_ROLL).backward()
    norm = torch.sqrt(sum(torch.sum(p.grad ** 2) for p in pmodel.parameters()))
    assert float(norm) > 1.0


# ---- the module's training mode ---------------------------------------------

def _old_eval_forward(m, x):
    """The module's forward as it ran before training mode existed."""
    h = m.feature_encoding(x.float()[..., None]) + m.pos_embedding[0]
    for blk in m.layers:
        y = blk.norm1(h).reshape(-1, *h.shape[-2:])
        a = blk.attention(y, y, y, need_weights=False)[0].reshape(h.shape)
        h = h + blk.dropout(a)
        h = h + blk.dropout(blk.ffn(blk.norm2(h)))
    return m.output_layer(h)[..., 0][..., : m.state_dim]


def test_eval_mode_is_unchanged_and_train_mode_without_dropout_agrees():
    torch.manual_seed(0)
    m = make_model("quadruped_attention", state_dim=19, hidden_dim=32)
    x = torch.randn(6, 31)
    with torch.no_grad():
        assert torch.equal(m(x), _old_eval_forward(m, x))
    assert torch.equal(m(x), _old_eval_forward(m, x))
    m0 = make_model("quadruped_attention", state_dim=19, hidden_dim=32, dropout_rate=0.0)
    m0.load_state_dict(m.state_dict())
    torch.testing.assert_close(m0.train()(x), m0.eval()(x), rtol=1e-5, atol=1e-5)


def test_train_mode_draws_one_attention_mask_shared_by_batch_and_heads(monkeypatch):
    """With the elementwise dropouts switched off, the only draw of a layer
    is one (F, F) mask; the layer's output is the attention with every
    (sample, head) weight matrix times mask / keep, computed here in numpy
    from the state_dict."""
    from humanoid_mppi_rl_tpu_torch.models import predictors

    rate, F, H, nh = 0.3, 31, 32, 4
    m = make_model("quadruped_attention", state_dim=19, hidden_dim=H, attn_layers=1,
                   dropout_rate=rate).double().train()
    draws = []
    real_rand = torch.rand

    def rand(*args, **kw):
        out = real_rand(*args, **kw)
        draws.append(out)
        return out
    monkeypatch.setattr(predictors, "_dropout", lambda x, r, g: x)
    monkeypatch.setattr(torch, "rand", rand)
    blk = m.layers[0]
    h = torch.randn(5, F, H, dtype=torch.float64)
    out = blk(h, torch.Generator().manual_seed(3)).detach().numpy()
    assert [tuple(d.shape) for d in draws] == [(F, F)]
    mask = (draws[0] < 1 - rate).numpy() / (1 - rate)

    sd = {k: v.detach().numpy() for k, v in blk.state_dict().items()}
    hn = h.numpy()
    mu, var = hn.mean(-1, keepdims=True), hn.var(-1, keepdims=True)
    y = (hn - mu) / np.sqrt(var + 1e-6) * sd["norm1.weight"] + sd["norm1.bias"]
    q, k, v = np.split(y @ sd["attention.in_proj_weight"].T + sd["attention.in_proj_bias"], 3,
                       axis=-1)
    heads = lambda a: a.reshape(5, F, nh, H // nh).transpose(0, 2, 1, 3)
    s = heads(q) @ heads(k).transpose(0, 1, 3, 2) / np.sqrt(H // nh)
    w = np.exp(s - s.max(-1, keepdims=True))
    w = w / w.sum(-1, keepdims=True) * mask
    a = (w @ heads(v)).transpose(0, 2, 1, 3).reshape(5, F, H)
    x1 = hn + a @ sd["attention.out_proj.weight"].T + sd["attention.out_proj.bias"]
    mu, var = x1.mean(-1, keepdims=True), x1.var(-1, keepdims=True)
    y2 = (x1 - mu) / np.sqrt(var + 1e-6) * sd["norm2.weight"] + sd["norm2.bias"]
    f = np.maximum(y2 @ sd["ffn.0.weight"].T + sd["ffn.0.bias"], 0)
    want = x1 + f @ sd["ffn.3.weight"].T + sd["ffn.3.bias"]
    np.testing.assert_allclose(out, want, rtol=1e-10, atol=1e-10)


def test_train_mode_elementwise_dropout_and_generator():
    """Elementwise dropouts: kept values scaled by 1/keep, the rest 0; the
    same generator state draws the same masks; eval mode draws nothing."""
    from humanoid_mppi_rl_tpu_torch.models.predictors import _dropout

    x = torch.randn(4000, dtype=torch.float64) + 5.0
    y = _dropout(x, 0.25, torch.Generator().manual_seed(1))
    kept = y != 0
    torch.testing.assert_close(y[kept], x[kept] / 0.75, rtol=0, atol=0)
    assert 0.70 < float(kept.double().mean()) < 0.80
    m = make_model("cartpole_attention", hidden_dim=16).train()
    x = torch.randn(3, 5)
    a, b = (m(x, torch.Generator().manual_seed(9)) for _ in range(2))
    assert torch.equal(a, b) and not torch.equal(a, m(x, torch.Generator().manual_seed(10)))
    g = torch.Generator().manual_seed(0)
    before = g.get_state()
    m.eval()(x, g)
    assert torch.equal(g.get_state(), before)


# ---- train_model behaviour (tests/test_learning.py's) -----------------------

TRAIN_WIDTH = dict(hidden_dim=16)   # the trainer's behaviour tests train a narrow model


def _cfg(tmp_path, **kw):
    base = dict(model_preset="cartpole_attention", lr=3e-3, epochs=14, batch_size=32,
                ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=0, eval_split=0.2,
                model_overrides=TRAIN_WIDTH)
    base.update(kw)
    return ptrain.TrainConfig(**base)


@pytest.mark.parametrize("scan", [False, True])
def test_train_model_converges_and_checkpoints(toy_dirs, tmp_path, scan):
    out = ptrain.train_model(*toy_dirs, _cfg(tmp_path, scan_epochs=scan, ckpt_every=7),
                             device="cpu")
    assert out["best_eval_loss"] < 0.08, out["best_eval_loss"]
    ck = tmp_path / "ckpt"
    assert set(os.listdir(ck)) - {"tb"} == {
        "metrics.jsonl", "model_best.pt", "model_epoch_7.pt", "model_epoch_14.pt",
        "model_final.pt", "state_last.pt", "train_summary.json"}
    assert out["best_checkpoint"] == str(ck / "model_best.pt")
    assert out["n_pairs"] == 4 * 59
    events = [json.loads(line) for line in open(ck / "metrics.jsonl")]
    epochs = [e for e in events if e["kind"] == "epoch"]
    assert [e["epoch"] for e in epochs] == list(range(14))
    assert min(e["eval_loss"] for e in epochs) == out["best_eval_loss"]
    summary = json.load(open(ck / "train_summary.json"))
    assert summary["best_eval_loss"] == out["best_eval_loss"]
    restored = ptrain.load_checkpoint(out["final_checkpoint"],
                                      make_model("cartpole_attention", **TRAIN_WIDTH))
    x = torch.randn(7, 5)
    torch.testing.assert_close(restored(x), out["model"].eval()(x), rtol=0, atol=0)


def test_resume_equals_an_uninterrupted_run(toy_dirs, tmp_path):
    """A 6-epoch run (dropout on) saves state_last after epoch 4; a job
    resumed from it runs epochs 4 and 5 and ends with the same weights."""
    whole = ptrain.train_model(*toy_dirs, _cfg(tmp_path, epochs=6, ckpt_every=4,
                                               ckpt_dir=str(tmp_path / "a")), device="cpu")
    resumed = ptrain.train_model(
        *toy_dirs, _cfg(tmp_path, epochs=6, ckpt_dir=str(tmp_path / "b"),
                        resume_from=str(tmp_path / "a" / "state_last.pt"),
                        log_path=str(tmp_path / "m.jsonl")), device="cpu")
    events = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    assert events[0]["kind"] == "resume" and events[0]["epoch"] == 4
    assert [e["epoch"] for e in events if e["kind"] == "epoch"] == [4, 5]
    for (name, a), b in zip(whole["model"].state_dict().items(),
                            resumed["model"].state_dict().values()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=name)


def test_rollout_k_training_runs_and_improves(tmp_path):
    """tests/test_learning.py's stable linear system, 4 x 100 rows."""
    rng = np.random.default_rng(0)
    A = np.eye(4) * 0.95 + 0.02 * rng.normal(size=(4, 4))
    B = 0.1 * rng.normal(size=(4, 1))
    (tmp_path / "states").mkdir()
    (tmp_path / "actions").mkdir()
    for t in range(4):
        x = rng.normal(size=4)
        xs, us = [], []
        for _ in range(100):
            u = rng.normal(size=1)
            xs.append(x.copy())
            us.append(u)
            x = A @ x + B @ u
        np.savetxt(tmp_path / "states" / f"t{t}.csv", np.asarray(xs), delimiter=",")
        np.savetxt(tmp_path / "actions" / f"t{t}.csv", np.asarray(us), delimiter=",")
    cfg = _cfg(tmp_path, lr=3e-4, epochs=6, scan_epochs=True, rollout_k=3, eval_split=0.1,
               log_path=str(tmp_path / "m.jsonl"))
    res = ptrain.train_model(str(tmp_path / "states"), str(tmp_path / "actions"), cfg,
                             device="cpu")
    assert np.isfinite(res["best_eval_loss"]) and res["rollout_k"] == 3
    epochs = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    assert len(epochs) == 6
    assert epochs[-1]["train_loss"] < epochs[0]["train_loss"]


def test_rollout_k_requires_delta_and_scan(tmp_path):
    (tmp_path / "states").mkdir()
    (tmp_path / "actions").mkdir()
    np.savetxt(tmp_path / "states" / "t.csv", np.zeros((10, 4)), delimiter=",")
    np.savetxt(tmp_path / "actions" / "t.csv", np.zeros((10, 1)), delimiter=",")
    dirs = (str(tmp_path / "states"), str(tmp_path / "actions"))
    with pytest.raises(ValueError, match="delta"):
        ptrain.train_model(*dirs, _cfg(tmp_path, rollout_k=3, return_type="raw",
                                       scan_epochs=True), device="cpu")
    with pytest.raises(ValueError, match="scan_epochs"):
        ptrain.train_model(*dirs, _cfg(tmp_path, epochs=1, rollout_k=3, scan_epochs=False),
                           device="cpu")


def test_loss_curve_png_and_none_without_matplotlib(toy_dirs, tmp_path, monkeypatch):
    png = str(tmp_path / "loss.png")
    ptrain.train_model(*toy_dirs, _cfg(tmp_path, epochs=2, plot_path=png), device="cpu")
    assert os.path.getsize(png) > 1000
    for name in ("matplotlib", "matplotlib.pyplot"):
        monkeypatch.setitem(__import__("sys").modules, name, None)
    assert ptrain.save_loss_curve(str(tmp_path / "none.png"), [(0, 1.0, 2.0)]) is None
    assert not os.path.exists(tmp_path / "none.png")


def test_train_model_refuses_cuda_without_a_card(toy_dirs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        ptrain.train_model(*toy_dirs, _cfg(tmp_path, epochs=1))


# ---- the trained weights ------------------------------------------------------

def test_trained_weights_file_equals_the_orbax_restore():
    """assets/quad_pipeline_best.pt = params_from_flax of the orbax restore
    of artifacts/quad_pipeline/ckpt/model_best, bit for bit; its forward
    equals flax apply at 2e-5."""
    path = os.path.join(ROOT, "artifacts", "quad_pipeline", "ckpt", "model_best")
    net = jax_make_model("quadruped_attention", state_dim=19)
    like = net.init(jax.random.PRNGKey(0), jnp.zeros((1, 31), jnp.float32), deterministic=True)
    params = jax.tree_util.tree_map(np.asarray, jtrain.load_checkpoint(path, like))
    want = params_from_flax(params, make_model("quadruped_attention", state_dim=19))
    got = torch.load(trained_path("quad_pipeline_best"), weights_only=True)
    assert list(got) == list(want)
    for name, w in want.items():
        assert got[name].dtype == torch.float32
        assert torch.equal(got[name], w), name
    mod = load_trained("quad_pipeline_best", device="cpu")
    x = np.random.default_rng(4).normal(size=(8, 31)).astype(np.float32)
    ref = np.asarray(net.apply(params, jnp.asarray(x), deterministic=True))
    np.testing.assert_allclose(mod(torch.from_numpy(x)).detach().numpy(), ref,
                               atol=2e-5, rtol=2e-5)
