"""The train-step options of the port against podtpu on the CPU: the
optimizers (adam, radam, adamw), ``flat``, ``accum_steps`` and
``skip_nonfinite`` with the schedule's count under both, the EMA shadow
(step, checkpoint, restore, ``cli.test --use-ema``, ``.npz`` reseed, eval
on the shadow), ``remat_policy`` / ``remat_backbone`` and QAT.

Tolerances: optimizer updates as ``tests/test_optim_parity.py`` (1e-6);
the EMA shadow as ``tests/test_ema.py`` (rtol 1e-5, atol 1e-6) against a
float64 recomputation of the blend; fake-quant as ``tests/test_qat.py``;
everything the port computes two ways (flat against per-tensor, remat
against the plain step, a rejected step against the state before it) bit
for bit.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import podtpu.train.optim as joptim
import podtpu.train.state as jstate
from podtpu.models.layers import ConvBnAct as JConvBnAct
from podtpu.models.layers import _fake_quant as podtpu_fake_quant
from podtpu.train.steps import remat_policy as podtpu_remat_policy
from podtpu_torch.export.weights import (
    flat_from_state_dict,
    load_npz_weights,
)
from podtpu_torch.models import darknet
from podtpu_torch.models.factory import build_model
from podtpu_torch.models.layers import ConvBnAct, fake_quant, remat_scope
from podtpu_torch.train import schedule as tsched
from podtpu_torch.train.optim import build_optimizer
from podtpu_torch.train.state import (
    TrainState,
    create_train_state,
    ema_options,
    total_notfinite,
)
from podtpu_torch.train.steps import (
    make_multi_train_step,
    make_train_step,
    remat_policy,
)
from podtpu_torch.train.trainer import (
    CheckpointIO,
    Trainer,
    restore_eval_weights,
    restore_weights,
)
from tests.torch_parity import (
    podtpu_flat_weights,
    yolo_cfg,
)

@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs six workers on the machine's
    cores, and these small tensors gain little from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- optimizers


class _Block(torch.nn.Module):
    """Two ConvBnAct blocks: kernels (decayed) and BN leaves (exempt)."""

    def __init__(self):
        super().__init__()
        torch.manual_seed(0)
        self.a = ConvBnAct(2, 3, 3)
        self.b = ConvBnAct(3, 4, 1)

    def forward(self, x):
        return self.b(self.a(x))


_LEAF = {"conv.weight": ("conv", "kernel"), "bn.weight": ("bn", "scale"),
         "bn.bias": ("bn", "bias")}


def _to_j(name, t):
    t = t.detach()
    return (t.permute(2, 3, 1, 0) if name.endswith("conv.weight") else t).numpy()


def _jtree(block, values):
    """{name: array} of the block's parameters -> podtpu's param tree."""
    tree = {}
    for n, _ in block.named_parameters():
        mod, leaf = n.split(".", 1)
        a, b = _LEAF[leaf]
        tree.setdefault(mod, {}).setdefault(a, {})[b] = jnp.asarray(values[n])
    return tree


def _jget(tree, n):
    mod, leaf = n.split(".", 1)
    a, b = _LEAF[leaf]
    return np.asarray(tree[mod][a][b])


class _Pair:
    """The port's TrainState and podtpu's optax chain on the same block,
    fed the same gradients."""

    def __init__(self, cfg):
        self.block = _Block()
        self.params = _jtree(self.block, {
            n: _to_j(n, p) for n, p in self.block.named_parameters()})
        self.tx = joptim.build_optimizer(cfg, self.params)
        self.opt_state = self.tx.init(self.params)
        opts = cfg["optimizer_options"]
        self.state = TrainState(
            self.block, build_optimizer(cfg, self.block),
            tsched.build_schedule(cfg),
            clip_norm=opts.get("clip_grad_norm"),
            accum=int(opts.get("accum_steps", 1)),
            skip=int(opts.get("skip_nonfinite", 0)))

    def step(self, grads: dict, finite: bool = True):
        jg = _jtree(self.block, {n: _to_j(n, torch.from_numpy(g))
                                 for n, g in grads.items()})
        upd, self.opt_state = self.tx.update(jg, self.opt_state, self.params)
        self.params = optax.apply_updates(self.params, upd)
        for n, p in self.block.named_parameters():
            p.grad = torch.from_numpy(grads[n].copy())
        self.state.apply_gradients(finite)

    def check(self, msg, atol=1e-6):
        for n, p in self.block.named_parameters():
            np.testing.assert_allclose(_to_j(n, p), _jget(self.params, n),
                                       rtol=1e-6, atol=atol, equal_nan=True,
                                       err_msg=f"{n} {msg}")


def _grads(block, rng, nan=False):
    g = {n: rng.normal(size=p.shape).astype(np.float32)
         for n, p in block.named_parameters()}
    if nan:
        g["a.conv.weight"].flat[0] = np.nan
    return g


def _opt_cfg(optimizer="sgd", policy=None, **opts):
    o = {"lr": 0.01, "momentum": 0.9, "nesterov": True, "weight_decay": 0.05,
         **opts}
    if policy:
        o["decay_policy"] = policy
    return {"model": "yolov3", "optimizer": optimizer, "optimizer_options": o,
            "scheduler": "yolo_lr",
            "scheduler_options": {"burn_in": 3, "steps": [4], "scales": [0.1]}}


@pytest.mark.parametrize("optimizer,policy", [
    ("adam", None), ("radam", None), ("adamw", None), ("adamw", "all"),
    ("adam", "all")])
def test_optimizer_matches_optax_over_three_steps(optimizer, policy):
    """adam / radam (coupled decay ahead of them) and adamw (decoupled,
    masked) with the clip first, three updates under yolo_lr."""
    pair = _Pair(_opt_cfg(optimizer, policy, clip_grad_norm=3.0))
    rng = np.random.default_rng(1)
    for i in range(3):
        pair.step(_grads(pair.block, rng))
        pair.check(f"after update {i}")
    assert pair.state.count == pair.state.step == 3


def test_unknown_optimizer_raises_like_podtpu():
    cfg = _opt_cfg("lamb")
    with pytest.raises(ValueError, match="unknown optimizer 'lamb'"):
        build_optimizer(cfg, _Block())
    with pytest.raises(ValueError, match="unknown optimizer 'lamb'"):
        joptim.build_optimizer(cfg, _Pair(_opt_cfg()).params)


@pytest.mark.parametrize("policy", [None, "all"])
def test_flat_is_bit_equal_to_the_per_tensor_path(policy):
    """``flat`` (one buffer of parameters, one of gradients) against the
    per-tensor SGD path bit for bit, and against podtpu's ``optax.flatten``
    chain to 1e-6, over four clipped updates."""
    cfg = _opt_cfg(policy=policy, clip_grad_norm=4.0)
    flat_cfg = _opt_cfg(policy=policy, clip_grad_norm=4.0, flat=True)
    per, pair = _Pair(cfg), _Pair(flat_cfg)
    assert pair.state.optimizer.flat is not None
    assert len(pair.state.optimizer.param_groups) == (1 if policy else 2)
    rng = np.random.default_rng(2)
    for i in range(4):
        g = _grads(per.block, rng)
        per.step(g)
        pair.step(g)
        pair.check(f"flat after update {i}")
        for (n, a), b in zip(per.block.named_parameters(),
                             pair.block.parameters()):
            assert torch.equal(a, b), n
    assert pair.state.optimizer.flat.param.data_ptr() == \
        next(pair.block.parameters()).data_ptr()


def test_accum_matches_optax_multisteps():
    """accum_steps 2 over six calls (three updates, burn-in lr): the
    running mean, the inner update every second call, compared after every
    call."""
    pair = _Pair(_opt_cfg(accum_steps=2, clip_grad_norm=3.0))
    rng = np.random.default_rng(3)
    for i in range(6):
        pair.step(_grads(pair.block, rng))
        pair.check(f"after call {i}")
        assert pair.state.count == (i + 1) // 2
        assert pair.state.mini_step == (i + 1) % 2


def test_accum_matches_the_big_batch_gradient():
    """k micro-batch gradients accumulated equal one update on their mean
    (tests/test_optim_parity.py:80)."""
    cfg = _opt_cfg(accum_steps=2)
    cfg["scheduler"] = None
    acc, big = _Pair(cfg), _Pair(_opt_cfg())
    big.state.schedule = acc.state.schedule
    rng = np.random.default_rng(4)
    g1, g2 = _grads(acc.block, rng), _grads(acc.block, rng)
    acc.step(g1)
    acc.step(g2)
    for n, p in big.block.named_parameters():
        p.grad = torch.from_numpy((g1[n] + g2[n]) / 2)
    big.state.apply_gradients()
    for (n, a), b in zip(acc.block.named_parameters(), big.block.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=n)


def _snapshot(state):
    params = [p.detach().clone() for p in state.model.parameters()]
    opt = [v.clone() for s in state.optimizer.state.values()
           for v in s.values() if isinstance(v, torch.Tensor)]
    return params, opt, (state.count, state.mini_step)


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a[0] + a[1], b[0] + b[1])) \
        and a[2] == b[2]


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_skip_nonfinite_matches_apply_if_finite(optimizer):
    """skip_nonfinite 2: a rejected call leaves parameters, optimizer state
    and the schedule's count bit for bit; the count of non-finite steps
    matches optax's; the third bad call in a row is applied."""
    pair = _Pair(_opt_cfg(optimizer, skip_nonfinite=2))
    rng = np.random.default_rng(5)
    pattern = [False, True, False, False, True, True, True]
    for i, bad in enumerate(pattern):
        before = _snapshot(pair.state)
        pair.step(_grads(pair.block, rng, nan=bad), finite=not bad)
        pair.check(f"after call {i}")
        rejected = bad and i != 6
        assert _same(before, _snapshot(pair.state)) == rejected, i
        assert total_notfinite(pair.state) == joptim.total_notfinite(
            pair.opt_state)
    assert pair.state.step == 7 and pair.state.count == 4
    assert total_notfinite(pair.state) == 4
    assert np.isnan(next(pair.block.parameters()).detach().numpy()).any()
    assert total_notfinite(_Pair(_opt_cfg()).state) is None


def test_schedule_count_under_accum_and_skip():
    """accum_steps 2 and skip_nonfinite 2 with one planted non-finite
    micro-batch: the lr applied follows optax's inner count (updates
    applied), not the step; parameters compared after every call."""
    pair = _Pair(_opt_cfg(accum_steps=2, skip_nonfinite=2))
    rng = np.random.default_rng(6)
    for i, bad in enumerate([False, True, False, False, False, False]):
        pair.step(_grads(pair.block, rng, nan=bad), finite=not bad)
        pair.check(f"after call {i}")
    # 5 accepted micro-steps: two updates; schedule(step // 2) would be 3
    assert (pair.state.step, pair.state.count, pair.state.mini_step) == (
        6, 2, 1)
    assert pair.state.schedule(2) != pair.state.schedule(3)


# ------------------------------------------------------- the train step


def _tiny_cfg(**extra):
    """yolov4-tiny at 64 px, 3 classes (tests/test_tta.py's config): a
    narrow model, for the options that do not need Darknet-19."""
    cfg = {"model": "yolov4-tiny", "num_classes": 3, "input_size": 64,
           "in_channels": 3, "compute_dtype": "float32",
           "anchors": [[4, 5], [6, 8], [10, 9], [12, 16], [18, 14],
                       [20, 24], [32, 28], [40, 44], [56, 52]],
           "conf_threshold": 0.1, "top_k_candidates": 32,
           "max_detections": 10, "max_annots": 8, "optimizer": "sgd",
           "optimizer_options": {"lr": 1e-3, "momentum": 0.9},
           "scheduler": None, "seed": 0}
    cfg.update(extra)
    return cfg


def _opts(**kw):
    return {"lr": 1e-3, "momentum": 0.9, "nesterov": True,
            "weight_decay": 5e-4, **kw}


def _v3_cfg(**extra):
    """YOLOv3 at 64 px: Darknet-19, for the fused stem and
    ``remat_backbone``."""
    cfg = yolo_cfg(max_annots=8, optimizer="sgd", scheduler=None,
                   optimizer_options=_opts())
    cfg.update(extra)
    return cfg


def _step_cfg(model, **extra):
    if model == "v3":
        return _v3_cfg(**extra)
    extra.setdefault("optimizer_options", _opts())
    return _tiny_cfg(**extra)


def _batches(n, classes, seed):
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        img = r.random((2, 64, 64, 3), np.float32)
        annot = -np.ones((2, 8, 5), np.float32)
        annot[:, :2] = [[0.5, 0.5, 0.3, 0.4, 1],
                        [0.3, 0.6, 0.2, 0.2, classes - 1]]
        out.append({"img": torch.from_numpy(img),
                    "annot": torch.from_numpy(annot)})
    return out


def _run(cfg, flat, batches, record_grads=False):
    state = create_train_state(cfg, "cpu", weights=flat)
    step = make_train_step(cfg)
    grads = []
    if record_grads:
        apply = state.apply_gradients

        def spy(finite=True):
            grads.append([p.grad.clone() for p in state.params()])
            return apply(finite)

        state.apply_gradients = spy
    for b in batches:
        state, _ = step(state, b)
    return state, grads


@pytest.fixture(scope="module")
def steps():
    """Per model ("tiny", "v3"): flat weights, four batches, and one plain
    step from them with its gradients (the reference of the remat
    tests)."""
    out = {}
    for model, classes, seed in (("tiny", 3, 5), ("v3", 20, 3)):
        cfg = _step_cfg(model)
        flat = podtpu_flat_weights(cfg, seed=seed)
        batches = _batches(4, classes, seed + 4)
        out[model] = (flat, batches,
                      _run(cfg, flat, batches[:1], record_grads=True))
    return out


def _sd_equal(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    return all(torch.equal(sa[k], sb[k]) for k in sa)


@pytest.mark.parametrize("model,extra", [
    ("tiny", {"remat_policy": "conv_out"}),
    ("tiny", {"remat_policy": "no_post_act"}),
    ("v3", {"remat_backbone": True}),
    ("v3", {"remat_backbone": True, "remat_policy": "conv_out"})],
    ids=["conv_out", "no_post_act", "remat_backbone", "backbone+conv_out"])
def test_remat_gradients_and_running_stats_bit_equal(steps, model, extra):
    """One remat step against the plain step: every gradient, the
    parameters and the BN running statistics (moved once, not again by the
    recompute) bit for bit; the recompute was used."""
    flat, batches, (plain, g0) = steps[model]
    hits = []
    orig = darknet.checkpoint if "remat_backbone" in extra else None

    def counting_checkpoint(*a, **kw):
        hits.append("stage")
        return orig(*a, **kw)

    pack = []
    from podtpu_torch.models import layers

    real_registry = layers._Registry

    class Registry(real_registry):
        def pack(self, t):
            out = super().pack(t)
            pack.append(out is not t)
            return out

    mp = pytest.MonkeyPatch()
    mp.setattr(layers, "_Registry", Registry)
    if orig is not None:
        mp.setattr(darknet, "checkpoint", counting_checkpoint)
    try:
        got, g1 = _run(_step_cfg(model, **extra), flat, batches[:1],
                       record_grads=True)
    finally:
        mp.undo()
    assert all(torch.equal(a, b) for a, b in zip(g0[0], g1[0]))
    assert _sd_equal(plain, got)
    if "remat_policy" in extra:
        assert sum(pack) > 0  # tensors recomputed in the backward
    if orig is not None:
        assert hits.count("stage") == 5  # stages 1-5; the stem stays fused


class _Chain(torch.nn.Module):
    """Four ConvBnAct blocks in bf16, a pool after the second."""

    def __init__(self):
        super().__init__()
        torch.manual_seed(0)
        dt = torch.bfloat16
        self.blocks = torch.nn.ModuleList([
            ConvBnAct(3, 8, 3, dtype=dt), ConvBnAct(8, 8, 1, dtype=dt),
            ConvBnAct(8, 16, 3, dtype=dt), ConvBnAct(16, 8, 1, dtype=dt)])

    def forward(self, x):
        for i, b in enumerate(self.blocks):
            x = b(x)
            if i == 1:
                x = torch.nn.functional.max_pool2d(x, 2)
        return x


@pytest.mark.parametrize("policy", ["conv_out", "no_post_act"])
def test_remat_frees_what_it_recomputes(policy):
    """After a bf16 forward under the policy no tensor that the backward
    recomputes is alive (the autograd graph keeps recipes, not them), and
    in the backward a recomputed tensor is dropped once the nodes that
    read it ran; the plain forward keeps every block's activation."""
    import gc
    import weakref

    from podtpu_torch.models import layers

    model = _Chain().train()
    x = torch.rand(2, 3, 32, 32)
    seen = []
    real = layers._Registry

    class Registry(real):
        def add(self, t, fn):
            super().add(t, fn)
            seen.append(self.entries[layers._key(t)][0])

    mp = pytest.MonkeyPatch()
    mp.setattr(layers, "_Registry", Registry)
    try:
        with remat_scope(policy):
            out = model(x)
    finally:
        mp.undo()
    gc.collect()
    # the last block's output is the model's and stays
    assert len(seen) >= 4 and sum(r() is not None for r in seen) == 1
    recipes, live = [], []
    call = layers._Recipe.__call__

    def counted(self):
        recipes.append(weakref.ref(self))
        value = call(self)
        live.append(sum(1 for r in recipes
                        if r() is not None and r().value is not None))
        return value

    mp.setattr(layers._Recipe, "__call__", counted)
    try:
        out.float().sum().backward()
    finally:
        mp.undo()
    assert len(live) >= 4 and max(live) <= 2
    ys = []
    handles = [b.register_forward_hook(
        lambda m, a, y: ys.append(weakref.ref(y))) for b in model.blocks]
    out = model(x)
    for h in handles:
        h.remove()
    gc.collect()
    assert len(ys) == 4 and all(r() is not None for r in ys)


def test_remat_policy_names_like_podtpu():
    assert remat_policy({}) is None is podtpu_remat_policy({})
    assert remat_policy({"remat_policy": "conv_out"}) == "conv_out"
    for fn in (remat_policy, podtpu_remat_policy):
        with pytest.raises(ValueError, match="unknown remat policy"):
            fn({"remat_policy": "everything"})
    with pytest.raises(ValueError, match="unknown remat policy"):
        with remat_scope("everything"):
            pass


def _nan_batch(batch):
    img = batch["img"].clone()
    img[0, 5, 5, 0] = float("nan")
    return {"img": img, "annot": batch["annot"]}


def test_rejected_train_step_leaves_the_state_bit_for_bit(steps):
    """skip_nonfinite 2 in the train step: a batch with a NaN pixel leaves
    parameters, momentum, the count and the BN statistics as they were
    (the BN guard), counts one non-finite step; a third bad step in a row
    is applied while the BN statistics stay guarded."""
    flat, batches, _ = steps["tiny"]
    cfg = _step_cfg("tiny", optimizer_options=_opts(skip_nonfinite=2))
    state = create_train_state(cfg, "cpu", weights=flat)
    step = make_train_step(cfg)
    state, _ = step(state, batches[0])
    sd = {k: v.clone() for k, v in state.model.state_dict().items()}
    before = _snapshot(state)
    state, m = step(state, _nan_batch(batches[1]))
    assert not torch.isfinite(m["loss"])
    assert _same(before, _snapshot(state))
    assert all(torch.equal(v, state.model.state_dict()[k])
               for k, v in sd.items())
    assert (state.step, state.count, total_notfinite(state)) == (2, 1, 1)
    for _ in range(2):
        state, _ = step(state, _nan_batch(batches[1]))
    assert (state.step, state.count, total_notfinite(state)) == (4, 2, 3)
    params = torch.cat([p.detach().reshape(-1)
                        for p in state.model.parameters()])
    assert torch.isnan(params).any()
    assert all(torch.equal(v, sd[k]) for k, v in
               state.model.state_dict().items() if "running" in k)


def test_multi_step_group_carries_the_options(steps):
    """make_multi_train_step with ema, accum_steps 2, skip_nonfinite and a
    remat policy: the K=3 group bit-equal to three single steps."""
    flat, batches, _ = steps["tiny"]
    cfg = _step_cfg("tiny", ema={"decay": 0.9, "tau": 2.0},
                    remat_policy="conv_out",
                    optimizer_options=_opts(accum_steps=2, skip_nonfinite=1))
    seq = [batches[0], _nan_batch(batches[1]), batches[2]]
    singles, _ = _run(cfg, flat, seq)
    group = create_train_state(cfg, "cpu", weights=flat)
    stacked = {k: torch.stack([b[k] for b in seq]) for k in seq[0]}
    group, m = make_multi_train_step(cfg)(group, stacked)
    assert m["loss"].shape == (3,)
    assert _sd_equal(singles, group)
    assert all(torch.equal(singles.ema[k], group.ema[k]) for k in group.ema)
    assert (group.step, group.count, group.total_notfinite) == (3, 1, 1)


def test_flat_train_step_bit_equal(steps):
    flat, batches, _ = steps["tiny"]
    a, _ = _run(_step_cfg("tiny"), flat, batches[:2])
    b, _ = _run(_step_cfg("tiny", optimizer_options=_opts(flat=True)), flat,
                batches[:2])
    assert _sd_equal(a, b)
    mom_a = [a.optimizer.state[p]["momentum_buffer"] for p in a.params()]
    mom_b = torch.cat([b.optimizer.state[t]["momentum_buffer"]
                       for t in b.optimizer.flat.groups])
    assert torch.equal(torch.cat([m.reshape(-1) for m in mom_a]), mom_b)


# ------------------------------------------------------------------- EMA


def test_ema_options_match_podtpu():
    for cfg in ({}, {"ema": False}, {"ema": True}, {"ema": 0.995},
                {"ema": {"decay": 0.95, "eval": False}},
                {"ema": {"tau": 10}}):
        assert ema_options(cfg) == jstate.ema_options(cfg)


@pytest.mark.parametrize("k", [1, 2])
def test_ema_blend_matches_the_recurrence(steps, k):
    """The shadow after four steps against a float64 recomputation of
    podtpu's blend over the recorded states: ``d = decay * (1 - exp(-(step
    // k) / tau))``, blended only where ``step % k == 0``; parameters and
    BN running statistics."""
    flat, batches, _ = steps["tiny"]
    decay, tau = 0.9, 3.0
    cfg = _step_cfg("tiny", ema={"decay": decay, "tau": tau},
                    optimizer_options=_opts(accum_steps=k))
    state = create_train_state(cfg, "cpu", weights=flat)
    step = make_train_step(cfg)
    shadow = {n: v.double().clone() for n, v in state.ema.items()}
    assert all(torch.equal(state.ema[n], v) for n, v in
               state.model.state_dict().items())
    for i, b in enumerate(batches, start=1):
        state, _ = step(state, b)
        if i % k == 0:
            d = decay * (1.0 - np.exp(-(i // k) / tau))
            sd = state.model.state_dict()
            shadow = {n: e * d + sd[n].double() * (1.0 - d)
                      for n, e in shadow.items()}
    for n, want in shadow.items():
        np.testing.assert_allclose(state.ema[n].numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=n)


@pytest.fixture(scope="module")
def tiny(steps):
    flat, batches, _ = steps["tiny"]
    return flat, batches[0]


def test_ema_checkpoint_round_trip_and_restores(tiny, tmp_path):
    """Full restore carries the shadow; ``restore_weights(use_ema=True)``
    loads it as the weights, plain restore the raw ones, auto follows
    ``ema.eval``; a pre-EMA checkpoint reseeds the shadow from the
    restored weights and refuses ``use_ema=True``; an EMA checkpoint
    restores into a plain config."""
    flat, batch = tiny
    ema_cfg = _tiny_cfg(ema={"decay": 0.9, "tau": 2.0})
    state = create_train_state(ema_cfg, "cpu", weights=flat)
    step = make_train_step(ema_cfg)
    for _ in range(2):
        state, _ = step(state, batch)
    io = CheckpointIO(str(tmp_path / "ema"))
    io.save("last", state)
    last = str(tmp_path / "ema" / "last")

    fresh = create_train_state(ema_cfg, "cpu")
    restored = io.restore(last, fresh)
    assert all(torch.equal(restored.ema[k], v) for k, v in state.ema.items())
    assert (restored.step, restored.count) == (2, 2)

    def weights(s):
        return s.model.state_dict()

    got = restore_weights(last, create_train_state(ema_cfg, "cpu"),
                          use_ema=True)
    assert got.ema is None
    assert all(torch.equal(weights(got)[k], v) for k, v in state.ema.items())
    raw = restore_weights(last, create_train_state(ema_cfg, "cpu"))
    assert _sd_equal(raw, state)
    auto = restore_eval_weights(last, create_train_state(ema_cfg, "cpu"),
                                ema_cfg)
    assert all(torch.equal(weights(auto)[k], v) for k, v in state.ema.items())
    off = dict(ema_cfg, ema={"decay": 0.9, "eval": False})
    assert _sd_equal(restore_eval_weights(
        last, create_train_state(off, "cpu"), off), state)

    plain_cfg = _tiny_cfg()
    plain = create_train_state(plain_cfg, "cpu", weights=flat)
    plain, _ = step(plain, batch)
    io.save("plain", plain)
    pre = str(tmp_path / "ema" / "plain")
    resumed = io.restore(pre, create_train_state(ema_cfg, "cpu"))
    assert all(torch.equal(resumed.ema[k], v)
               for k, v in weights(plain).items())
    assert _sd_equal(restore_eval_weights(
        pre, create_train_state(ema_cfg, "cpu"), ema_cfg), plain)
    with pytest.raises(ValueError, match="no EMA shadow"):
        restore_weights(pre, create_train_state(ema_cfg, "cpu"), use_ema=True)
    into_plain = io.restore(last, create_train_state(plain_cfg, "cpu"))
    assert into_plain.ema is None and _sd_equal(into_plain, state)


def test_npz_load_reseeds_the_shadow(tiny, tmp_path):
    """``load_npz_weights`` into an EMA state reseeds its shadow from the
    loaded weights, as podtpu's ``load_npz_weights`` does (its
    ``init_ema``): the shadow equals the file, leaf for leaf."""
    flat, _ = tiny
    path = str(tmp_path / "w.npz")
    np.savez(path, **flat)
    cfg = _tiny_cfg(ema={"decay": 0.9})
    state = create_train_state(cfg, "cpu")
    assert load_npz_weights(state, path) is state
    probe = build_model(cfg, "cpu")
    probe.load_state_dict(state.ema)
    got = flat_from_state_dict(probe)
    assert set(got) == set(flat)
    for key, want in flat.items():
        np.testing.assert_array_equal(got[key], want)
    assert _sd_equal(state, TrainState(probe, None, None))


def test_trainer_evaluates_on_the_shadow(tiny):
    flat, batch = tiny
    cfg = _tiny_cfg(ema={"decay": 0.9}, batch_size=2)
    tr = Trainer(cfg, eval_only=True, device="cpu", log=lambda *_: None)
    tr.state, _ = make_train_step(cfg)(tr.state, batch)
    es = tr._eval_state()
    assert es.model is not tr.state.model and es.ema is None
    sd = es.model.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in tr.state.ema.items())
    off = _tiny_cfg(ema={"decay": 0.9, "eval": False}, batch_size=2)
    tr2 = Trainer(off, eval_only=True, device="cpu", log=lambda *_: None)
    assert tr2._eval_state() is tr2.state


def test_fit_with_ema_and_accum_then_test_use_ema(tmp_path):
    """A short ``Trainer.fit`` with ema and accum_steps 2 from files (the
    lr logged as schedule(step // 2), the skipped-update count), then
    ``cli.test`` on its ``best``: --use-ema scores the shadow (the fit's
    own val numbers), --no-use-ema the raw weights."""
    from podtpu_torch.cli import test as test_cli
    from podtpu_torch.data.synthetic import generate

    data = generate(str(tmp_path / "data"), n_train=8, n_val=4, size=80,
                    num_classes=3, max_objects=3, seed=2)
    from podtpu_torch.config import get_configs

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = get_configs(os.path.join(repo, "configs", "yolov4-tiny_voc.yaml"))
    cfg.update(_tiny_cfg(
        ema={"decay": 0.9, "tau": 2.0}, batch_size=2, workers=1, epochs=1,
        optimizer_options={"lr": 1e-3, "momentum": 0.9, "accum_steps": 2,
                           "skip_nonfinite": 1},
        scheduler="yolo_lr",
        scheduler_options={"burn_in": 8, "steps": [100], "scales": [0.1]},
        train_list=data["train_list"], val_list=data["val_list"],
        names=data["names"], save_dir=str(tmp_path / "runs"), save_freq=100,
        steps_per_dispatch=1, trainer_options={"check_val_every_n_epoch": 1}))
    logs = []
    tr = Trainer(cfg, device="cpu", log=logs.append)
    tr._writer = _Rec()
    from podtpu_torch.data.dataset import build_datasets
    from podtpu_torch.data.loader import Loader

    train_ds, val_ds = build_datasets(cfg)
    mk = lambda ds, sh: Loader(ds, batch_size=2, shuffle=sh,  # noqa: E731
                               max_annots=8, workers=1)
    (row,) = tr.fit(mk(train_ds, True), mk(val_ds, False))
    assert (row["step"], tr.state.count) == (4, 2)
    assert row["lr"] == tr.state.schedule(2) != tr.state.schedule(4)
    assert row["skipped_updates"] == 0
    assert ("skipped_nonfinite_updates", 0.0, 4) in tr._writer.scalars
    best = os.path.join(tr.run_dir, "checkpoints", "best")
    ema_res = test_cli.evaluate(cfg, best, device="cpu", use_ema=True)
    assert ema_res["val_loss"] == pytest.approx(row["val_loss"], rel=1e-6)
    raw = test_cli.evaluate(cfg, best, device="cpu", use_ema=False)
    assert raw["val_loss"] != ema_res["val_loss"]
    argv = ["--cfg", _write_cfg(cfg, tmp_path), "--ckpt", best, "--device",
            "cpu", "--use-ema"]
    assert test_cli.main(argv)["val_loss"] == ema_res["val_loss"]


class _Rec:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), int(step)))

    def add_image(self, *a, **k):
        pass

    def flush(self):
        pass


def _write_cfg(cfg, tmp_path):
    import yaml

    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


# ------------------------------------------------------------------- QAT


def test_fake_quant_values_and_ste_match_podtpu():
    """Per tensor and per output channel (podtpu's HWIO dims 0-2 are the
    port's OIHW dims 1-3): the same values, on the int8 grid, and a
    straight-through gradient of ones."""
    rng = np.random.default_rng(9)
    x = rng.normal(0, 2, (2, 5, 6, 3)).astype(np.float32)
    got = fake_quant(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(podtpu_fake_quant(
        jnp.asarray(x))))
    s = np.abs(x).max() / 127.0
    np.testing.assert_allclose(got / s, np.round(got / s), atol=1e-5)
    w = rng.normal(0, 1, (4, 3, 3, 3)).astype(np.float32)  # OIHW
    got = fake_quant(torch.from_numpy(w), dims=(1, 2, 3)).numpy()
    want = np.asarray(podtpu_fake_quant(
        jnp.asarray(w.transpose(2, 3, 1, 0)), axis=(0, 1, 2)))
    np.testing.assert_array_equal(got, want.transpose(3, 2, 0, 1))
    ratio = got / (np.abs(w).max(axis=(1, 2, 3), keepdims=True) / 127.0)
    np.testing.assert_allclose(ratio, np.round(ratio), atol=1e-4)
    t = torch.from_numpy(x).requires_grad_()
    fake_quant(t).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), 1.0, atol=1e-6)


def test_qat_block_train_forward_and_grads_match_podtpu():
    """A QAT ConvBnAct in train mode against podtpu's (output 1e-5, input
    and kernel gradients through the STE 1e-4 of their scale); eval mode
    is the float block's."""
    rng = np.random.default_rng(10)
    x = rng.normal(0, 1, (2, 8, 8, 3)).astype(np.float32)
    jblock = JConvBnAct(4, 3, qat=True)
    variables = jblock.init(jax.random.PRNGKey(0), jnp.asarray(x))
    kernel = np.asarray(variables["params"]["conv"]["kernel"])
    block = ConvBnAct(3, 4, 3)
    with torch.no_grad():
        block.conv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()))
    block.qat = True

    def jloss(params, xx):
        y, _ = jblock.apply({**variables, "params": params}, xx, train=True,
                            mutable=["batch_stats"])
        return jnp.sum(y * y), y

    (_, jy), (jg, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(variables["params"],
                                              jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y = block(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    (y * y).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=1e-5)
    gw = block.conv.weight.grad.permute(2, 3, 1, 0).numpy()
    want = np.asarray(jg["conv"]["kernel"])
    np.testing.assert_allclose(gw, want, atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx),
                               atol=1e-4 * np.abs(np.asarray(jgx)).max())
    block.eval()
    plain = ConvBnAct(3, 4, 3).eval()
    plain.load_state_dict(block.state_dict())
    xe = torch.from_numpy(x).permute(0, 3, 1, 2)
    assert torch.equal(block(xe), plain(xe))


@pytest.mark.parametrize("model", ["yolov3", "yolov4-tiny", "retinanet",
                                   "yolov1", "yolov2", "yolov4"])
def test_qat_threads_through_every_family(model):
    cfg = {"model": model, "num_classes": 3, "input_size": 64,
           "anchors": [[4, 5]] * 9, "scaled_anchors": [[1, 1]] * 5,
           "num_boxes": 2, "qat": True}
    blocks = [m for m in build_model(cfg, "cpu").modules()
              if isinstance(m, ConvBnAct)]
    assert blocks and all(b.qat for b in blocks)
    cfg["qat"] = False
    assert not any(m.qat for m in build_model(cfg, "cpu").modules()
                   if isinstance(m, ConvBnAct))


def test_qat_train_step_keeps_the_stem_unfused(steps, monkeypatch):
    """Under QAT the fused stem is off (every block trains on the int8
    grid) and the loss is finite; the eval forward is the float model's;
    without QAT a train-mode forward fuses the stem once."""
    flat, batches, _ = steps["v3"]
    calls = []
    real = darknet.fused_stem_pool
    monkeypatch.setattr(darknet, "fused_stem_pool",
                        lambda *a: calls.append(1) or real(*a))
    x = batches[1]["img"]
    with torch.no_grad():
        build_model(_v3_cfg(), "cpu", train=True)(x)
    assert len(calls) == 1
    q = create_train_state(_v3_cfg(qat=True), "cpu", weights=flat)
    q, m = make_train_step(_v3_cfg(qat=True))(q, batches[0])
    assert len(calls) == 1 and torch.isfinite(m["loss"])
    plain = build_model(_v3_cfg(), "cpu")
    plain.load_state_dict(q.model.state_dict())
    q.model.eval()
    with torch.no_grad():
        assert all(torch.equal(a, b) for a, b in zip(q.model(x), plain(x)))
