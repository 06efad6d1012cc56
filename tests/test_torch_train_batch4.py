"""Training at batch 4, the JAX AP records' own batch, on the CPU: the
port's quality harness (cli/train_to_ap.py --batch 4) against the JAX
tool's (tools/train_to_ap.py --batch 4), for GRID_REAS conv3d and
lstm3d at a small size (64^2, 2 views, nvox 8, 2 depth samples, a
1-block stage 4). The float64 steps of lstm3d are collected from
tests/test_torch_train_batch4_lstm3d.py, which imports them.

* Config: `train_config` at --batch 4 gives IMAGES_PER_GPU and
  BATCH_SIZE 4, key for key the config the JAX tool's main() trains
  with; `eval_config` keeps batch 1 in both (each rebuilds its config
  from the class).
* Batches: `make_batch(ds, cfg, rnd_state=k)` at batch 4 is bit-equal to
  JAX's for k = 0, 1, 2.
* The supervisor's segments (cli/train_supervisor.py, --max-rss-gb
  passed after every step) each train at batch 4: every segment's
  command carries --batch 4, and each resumed segment's steps take 4
  images.
* Three steps of each harness's own main() at --batch 4 (--device cpu
  for the port; SGD momentum carried across the steps, no LR drop),
  from the harness's seeded weights (float32 values, so the converter
  carries them exactly), both sides computing in float64. Every step's
  five losses and total within 1e-6 relative of JAX's, and after step 3
  every BatchNorm's running mean and variance within 1e-6 of the
  tensor's largest magnitude, each or within JAX's own spread of that
  number (the rule of tests/test_torch_mesh.py): how far JAX's loop
  moves it when run once more on batches nudged by one float32 rounding
  step a pixel.
* The first of those steps is the one-step comparison of
  `train/step.py::train_step` against JAX make_train_step: its losses
  and every BatchNorm's new statistics by the same rule (the statistics
  over the 4 images: N*H*W positions of a map, B*X*Y*Z voxels of a
  grid, B*N ROI rows in the heads), and every gradient within 1e-4 of
  its norm or within JAX's spread. Read on the CPU: the losses within
  2.3e-6 (conv3d's box loss: both compute it in float32 and sum in
  other orders; its spread 4.4e-6), the statistics within 1.2e-6 (the
  P6 depth collapse; its spread 6.3e-5), and after step 3 the losses
  within 6e-5 and the statistics within 5e-5 of the largest magnitude,
  where a nudge moves them by up to 50% and 10%.

The port samples the heads' ROIs from proposals rounded to float32
(ops/targets.py::detection_targets); in float64 JAX's would be float64,
so JAX's ROI sampling gets its proposals and ground truth boxes rounded
the same way, and both sides decide each proposal's IoU on the same
values.

Both sides sample the same ROI rows: the port's priorities (one draw of
the harness's generator, seeded --seed + 100) stand in for every step's
draw on both sides, the JAX ops/targets.py reading them through
tests/test_torch_mesh.py's `_Drawn`. Positive ROIs reach the box and
mask heads in the first step (both losses above 0). JAX compiles its
step once a mode, inside one float64 context, and its steps share it;
the port's loop and JAX's run in two threads.

JAX's spread is a committed table, `tests/fixtures/batch4_nudge_spread.json`:
for each mode, one float a loss and step, a statistic (after steps 1
and 3) and a gradient tensor, each |nudged - plain| of JAX's own loop
(max abs for the statistics, the norm for the gradients), with a
digest of the inputs it was computed from (the port's seeded weights
and ROI priorities). The JAX package is frozen, so the table does not
change; the nudged loop was the larger part of this file's time (XLA:CPU
runs float64 convolutions in its own loop nests, not Eigen's kernels:
tests/probe_xla_f64_conv.py times both), so Tier-1 reads the table and
runs the port and JAX live on the same inputs. `test_batch4_nudge_spread_table_is_current` (slow)
recomputes the table and holds it to the committed one, and
`python -m tests.test_torch_train_batch4` writes it anew.
"""

import contextlib
import hashlib
import json
import os
import sys
import threading
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mulit_view_object_detection_tpu.compat.model as jcompat_model  # noqa: E402
import mulit_view_object_detection_tpu.models.detector as jdetector  # noqa: E402
import mulit_view_object_detection_tpu.ops.targets as jtargets  # noqa: E402
import mulit_view_object_detection_tpu.train.step as jstep  # noqa: E402
from mulit_view_object_detection_tpu.data.generator import (  # noqa: E402
    make_batch as jax_make_batch)
from mulit_view_object_detection_tpu.data.synthetic import (  # noqa: E402
    SyntheticMultiViewDataset as JaxSynthetic)
from mulit_view_object_detection_tpu.train.optim import (  # noqa: E402
    make_optimizer as jax_make_optimizer)
import mulit_view_object_detection_torch.train.step as step_mod  # noqa: E402
from mulit_view_object_detection_torch.cli import (  # noqa: E402
    train_supervisor as sup, train_to_ap as tool)
from mulit_view_object_detection_torch.data.generator import (  # noqa: E402
    make_batch)
from mulit_view_object_detection_torch.kernels import unproject  # noqa: E402
from mulit_view_object_detection_torch.models.detector import (  # noqa: E402
    MaskRCNN as TorchMaskRCNN)
from mulit_view_object_detection_torch.models.layers import (  # noqa: E402
    set_compute_dtype)
from mulit_view_object_detection_torch.utils.convert import (  # noqa: E402
    flax_to_torch, torch_to_flax)
from tests.test_torch_mesh import _Drawn  # noqa: E402
from tools import train_to_ap as jax_tool  # noqa: E402

MODES = ("conv3d", "lstm3d")
SEED = 3
STEPS = 3
LOSS_TOL, STAT_TOL, GRAD_TOL = 1e-6, 1e-6, 1e-4
F64 = torch.float64
SPREAD_TABLE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "fixtures", "batch4_nudge_spread.json")


def _argv(mode):
    return ["--image-size", "64", "--num-views", "2", "--nvox", "8",
            "--samples", "2", "--scenes", "4", "--grid-reas", mode,
            "--stage4-blocks", "1", "--batch", "4", "--seed", str(SEED)]


def _stats(model):
    return {n: b.detach().clone() for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


def _to_f64(model):
    model.double()
    set_compute_dtype(model, F64)
    model.compute_dtype = F64
    return model


def _nudged(batch):
    """`batch` with every pixel moved by one float32 rounding step, its
    direction drawn from a seeded RandomState."""
    im = batch["images"]
    up = np.random.RandomState(0).rand(*im.shape) < 0.5
    return dict(batch, images=np.where(
        up, np.nextafter(im, np.float32(np.inf)),
        np.nextafter(im, np.float32(-np.inf))).astype(im.dtype))


_LOCAL = threading.local()      # each JAX loop's thread: nudge, records


class _NoEngine:
    """The JAX tool's inference engine, never used with --skip-eval."""

    def __init__(self, *a, **kw):
        pass

    def _ensure_state(self):
        pass


@contextlib.contextmanager
def _jax_float64(cfg, priorities, weights, monkeypatch):
    """The JAX package computing in float64 (x64 on, its modules' compute
    dtype patched) with its ROI sampling drawing `priorities` (the
    port's, each [B, P]), and the JAX tool's main() patched: its
    create_train_state gives a state from the port's float32 `weights`,
    every state sharing one optimizer and one apply function, so that
    make_train_step's step, compiled once, serves every run (a new tx or
    model is a new static field of the state, and jit would compile
    again); its train step is `_recording`'s, which nudges the batch
    when the calling thread asks and records the step for that thread;
    its engine is a stub."""
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        with monkeypatch.context() as m:
            drawn = jnp.asarray(np.stack([p.numpy() for p in priorities],
                                         1), jnp.float64)
            m.setattr(jtargets, "jax", types.SimpleNamespace(
                random=_Drawn, lax=jax.lax, vmap=jax.vmap))
            m.setattr(jdetector, "detection_targets_batch",
                      lambda rng, proposals, ids, boxes, *a, **kw:
                      jtargets.detection_targets_batch(
                          drawn, proposals.astype(jnp.float32), ids,
                          boxes.astype(jnp.float32), *a, **kw))
            m.setattr(jdetector.MaskRCNN, "_dtype",
                      lambda self: jnp.float64)
            tx = jax_make_optimizer(cfg.LEARNING_RATE,
                                    cfg.LEARNING_MOMENTUM,
                                    cfg.GRADIENT_CLIP_NORM)
            apply_fn = jdetector.MaskRCNN(cfg).apply
            step = jstep.make_train_step(cfg, "all", donate=False)

            def create_train_state(model, c, rng, batch, learning_rate=None):
                variables = torch_to_flax(weights)
                params, stats = jax.tree_util.tree_map(
                    lambda a: jnp.asarray(a, jnp.float64),
                    (variables["params"], variables["batch_stats"]))
                return jstep.TrainState(
                    step=jnp.zeros((), jnp.int32), params=params,
                    batch_stats=stats, opt_state=tx.init(params), tx=tx,
                    apply_fn=apply_fn)

            def recording(state, batch, rng):
                if _LOCAL.nudge:
                    batch = _nudged(batch)
                new, metrics = step(state, batch, rng)
                _LOCAL.metrics.append(
                    {k: float(v) for k, v in metrics.items()})
                if _LOCAL.states:
                    _LOCAL.states[2:] = [new]        # after the last step
                else:
                    _LOCAL.states[:] = [state, new]  # around the first
                return new, metrics

            m.setattr(jstep, "create_train_state", create_train_state)
            m.setattr(jstep, "make_train_step", lambda *a, **kw: recording)
            m.setattr(jcompat_model, "MaskRCNN", _NoEngine)
            yield
    finally:
        jax.config.update("jax_enable_x64", x64)


def _jax_changes(new, old):
    """(new - old) of every parameter and statistic as a state_dict, in
    float64: the converter rounds to float32, which keeps a change to
    6e-8 of itself."""
    return flax_to_torch(jax.tree_util.tree_map(
        lambda a, b: np.asarray(a - b),
        {"params": new.params, "batch_stats": new.batch_stats},
        {"params": old.params, "batch_stats": old.batch_stats}))


def _jax_loop(mode, nudge):
    """The JAX tool's main() for STEPS steps at --batch 4, inside
    `_jax_float64`, its batches nudged when asked. Returns (every step's
    metrics, the states before and after the first step, the state after
    the last)."""
    _LOCAL.nudge, _LOCAL.metrics, _LOCAL.states = nudge, [], []
    jax_tool.main(_argv(mode) + ["--steps", str(STEPS), "--lr-drop", "0",
                                 "--skip-eval", "--ap-thresh", "0"])
    states = _LOCAL.states
    return _LOCAL.metrics, states[0], states[1], states[-1]


def _port_loop(mode, priorities, monkeypatch):
    """The port's main() for STEPS steps at --batch 4 --device cpu, in
    float64. Returns (the initial float32 weights, the first step's
    gradients and statistics, every step's metrics, the model after)."""
    seen, start, first = [], {}, {}

    class Model(TorchMaskRCNN):
        def init_weights(self, generator=None):
            super().init_weights(generator)
            start.update({k: v.clone() for k, v in self.state_dict().items()})
            _to_f64(self)

    def recording(model, optimizer, batch, cfg, mask, generator, **kw):
        metrics = real(model, optimizer, batch, cfg, mask, generator, **kw)
        seen.append((model, {k: float(v) for k, v in metrics.items()}))
        if not first:
            first["grads"] = {n: p.grad.clone() for n, p in
                              model.named_parameters() if p.grad is not None}
            first["stats"] = _stats(model)
        return metrics

    real = tool.train_step
    with monkeypatch.context() as m:
        m.setattr(tool, "Model", Model)
        m.setattr(tool, "train_step", recording)
        m.setattr(step_mod, "draw_priorities", _pinned(priorities))
        tool.main(_argv(mode) + ["--steps", str(STEPS), "--lr-drop", "0",
                                 "--skip-eval", "--ap-thresh", "0",
                                 "--device", "cpu"])
    return start, first, [s[1] for s in seen], seen[-1][0]


def _pinned(priorities):
    pos, neg = priorities

    def draw_priorities(batch, config, generator, group=None):
        return dict(batch, pos_priority=pos.to(batch["images"].device),
                    neg_priority=neg.to(batch["images"].device))
    return draw_priorities


def _priorities(cfg):
    """One draw of the harness's ROI priorities (its generator seeded
    --seed + 100): (positive, negative), each [B, P]."""
    pri = step_mod.draw_priorities(
        {"images": torch.zeros(cfg.BATCH_SIZE, 1)}, cfg,
        torch.Generator().manual_seed(SEED + 100))
    return pri["pos_priority"], pri["neg_priority"]


def _compute(mode, monkeypatch, nudged=False):
    """Everything the step and loop tests read, for one mode: each
    harness's three steps (the port's in float64, JAX's in float64; the
    first step is the one-step comparison), and, with `nudged`, JAX's
    three again on nudged batches; without, JAX's spread from the
    committed table, whose inputs must be this run's (checked before
    the loops run). The loops run in threads of their own (JAX and torch
    compute outside the interpreter lock)."""
    args = tool.make_parser().parse_args(_argv(mode))
    cfg = tool.train_config(args)
    priorities = _priorities(cfg)
    model = TorchMaskRCNN(cfg)
    model.init_weights(torch.Generator().manual_seed(SEED))
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    del model
    inputs = _inputs_digest(weights, priorities)
    if not nudged:
        table = spread_table()[mode]
        assert table["inputs"] == inputs, (
            f"{mode}: the spread table was computed from other inputs; "
            "rewrite it with python -m tests.test_torch_train_batch4")
    nudges = (False, True) if nudged else (False,)
    with _jax_float64(cfg, priorities, weights, monkeypatch), \
            ThreadPoolExecutor(1 + len(nudges)) as pool:
        port = pool.submit(_port_loop, mode, priorities, monkeypatch)
        loops = {nudge: pool.submit(_jax_loop, mode, nudge)
                 for nudge in nudges}
        start, first, metrics, model = port.result()
        loops = {nudge: f.result() for nudge, f in loops.items()}
    for k, v in start.items():
        assert torch.equal(v, weights[k]), k    # the same seeded start

    def side(nudge):
        steps, before, after, last = loops[nudge]
        change = _jax_changes(after, before)
        return {"metrics": steps, "stats": _jax_stats(after),
                "grads": {n: -change[n] / cfg.LEARNING_RATE
                          for n in first["grads"]},
                "last_stats": _jax_stats(last)}

    out = {"mode": mode, "weights": weights, "inputs": inputs,
           "port": {"metrics": metrics, **first,
                    "last_stats": _stats(model)},
           "jax": side(False)}
    if nudged:
        out["nudged"] = side(True)
    else:
        out["spread"] = table["spread"]
    return out


def _inputs_digest(weights, priorities):
    """sha256 of the port's seeded weights and ROI priorities: the
    inputs the spread table was computed from."""
    h = hashlib.sha256()
    for k in sorted(weights):
        h.update(k.encode())
        h.update(weights[k].contiguous().numpy().tobytes())
    for p in priorities:
        h.update(p.contiguous().numpy().tobytes())
    return h.hexdigest()


def _max_abs(a, b):
    return float((a.double() - b.double()).abs().max())


def spread(ref, nudged):
    """JAX's own spread: how far its loop's every loss (each step),
    statistic (after steps 1 and 3, max abs) and first-step gradient
    (norm) moves from `ref` to `nudged` (its loop on nudged batches)."""
    return {
        "metrics": [{k: abs(n[k] - r[k]) for k in r}
                    for r, n in zip(ref["metrics"], nudged["metrics"])],
        "stats": {k: _max_abs(nudged["stats"][k], t)
                  for k, t in ref["stats"].items()},
        "last_stats": {k: _max_abs(nudged["last_stats"][k], t)
                       for k, t in ref["last_stats"].items()},
        "grads": {k: float((nudged["grads"][k].double()
                            - t.double()).norm())
                  for k, t in ref["grads"].items()}}


def spread_table():
    with open(SPREAD_TABLE) as f:
        return json.load(f)


def _jax_stats(state):
    return {k: v for k, v in flax_to_torch(jax.tree_util.tree_map(
        np.asarray, {"params": state.params,
                     "batch_stats": state.batch_stats})).items()
            if k.endswith(("running_mean", "running_var"))}


def computed(mode, tmp_path_factory, nudged=False):
    """The body of a `runs` fixture for `mode`: _compute with JAX's
    compilation cache in a temporary directory, the float64 model's
    device check off, and jax's config restored after."""
    monkeypatch = pytest.MonkeyPatch()
    old_cache = (jax.config.jax_compilation_cache_dir,
                 jax.config.jax_persistent_cache_min_compile_time_secs)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                       str(tmp_path_factory.mktemp("jax_cache")))
    monkeypatch.setattr(unproject, "_check_device", lambda t, what: None)
    try:
        yield _compute(mode, monkeypatch, nudged)
    finally:
        monkeypatch.undo()
        jax.config.update("jax_compilation_cache_dir", old_cache[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          old_cache[1])
        jax.clear_caches()


# conv3d here; lstm3d in tests/test_torch_train_batch4_lstm3d.py, so that
# the two float64 fixtures (minutes each) run on two test workers
@pytest.fixture(scope="module", params=["conv3d"])
def runs(request, tmp_path_factory):
    yield from computed(request.param, tmp_path_factory)


# ---------------------------------------------------------------------------
# config and batches
# ---------------------------------------------------------------------------

class _Stop(Exception):
    pass


def _jax_configs(mode, monkeypatch):
    """(the config the JAX tool's main() trains with, its EvalConfig),
    caught as it builds its model and its engine."""
    seen = {}
    real_model = jdetector.MaskRCNN

    def model(cfg):
        seen["train"] = cfg
        return real_model(cfg)

    class Engine:
        def __init__(self, mode, config, model_dir):
            seen["eval"] = config
            raise _Stop

    with monkeypatch.context() as m:
        m.setattr(jdetector, "MaskRCNN", model)
        m.setattr(jstep, "create_train_state", lambda *a, **kw: None)
        m.setattr(jstep, "make_train_step", lambda *a, **kw: None)
        m.setattr(jcompat_model, "MaskRCNN", Engine)
        with pytest.raises(_Stop):
            jax_tool.main(_argv(mode) + ["--steps", "1"])
    return seen["train"], seen["eval"]


@pytest.mark.parametrize("mode", MODES)
def test_batch4_config_matches_jax(mode, monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    want, want_eval = _jax_configs(mode, monkeypatch)
    args = tool.make_parser().parse_args(_argv(mode))
    cfg = tool.train_config(args)
    assert (cfg.IMAGES_PER_GPU, cfg.BATCH_SIZE) == (4, 4)
    assert (want.IMAGES_PER_GPU, want.BATCH_SIZE) == (4, 4)
    got, ref = cfg.to_dict(), want.to_dict()
    assert sorted(got) == sorted(ref)
    np.testing.assert_equal(got, ref)
    got_eval = tool.eval_config(cfg, args)
    assert (got_eval.IMAGES_PER_GPU, got_eval.BATCH_SIZE) == (1, 1)
    assert (want_eval.IMAGES_PER_GPU, want_eval.BATCH_SIZE) == (1, 1)
    np.testing.assert_equal(got_eval.to_dict(), want_eval.to_dict())


@pytest.mark.parametrize("k", [0, 1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_batch4_make_batch_bit_equal_to_jax(mode, k):
    args = tool.make_parser().parse_args(_argv(mode))
    cfg = tool.train_config(args)
    kw = dict(num_scenes=args.scenes, num_views=args.num_views,
              image_size=args.image_size,
              num_classes=tool.SYNTHETIC_CLASSES, seed=args.seed)
    got = make_batch(tool.make_dataset(args, args.scenes, args.seed), cfg,
                     rnd_state=k)
    ref = jax_make_batch(JaxSynthetic(**kw), cfg, rnd_state=k)
    assert set(got) == set(ref)
    assert got["images"].shape[0] == 4
    for name in ref:
        assert got[name].dtype == ref[name].dtype, name
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    # four images (scenes drawn with replacement), each with ground truth
    assert ((got["gt_class_ids"] > 0).sum(1) > 0).all()


def test_supervisor_segments_train_at_batch4(monkeypatch, tmp_path):
    """Every segment runs in this process (the supervisor's
    subprocess.call replaced by the port's main() on the same command
    line): two exit 75 after a step each, the third resumes at step 2
    and ends; each step's batch holds 4 images."""
    commands, images = [], []

    def call(cmd, env=None):
        commands.append(cmd)
        try:
            tool.main(cmd[3:])
        except SystemExit as e:
            return e.code
        return 0

    def step(model, optimizer, batch, *a, **kw):
        images.append(batch["images"].shape[0])
        return real(model, optimizer, batch, *a, **kw)

    real = tool.train_step
    monkeypatch.setattr(sup.subprocess, "call", call)
    monkeypatch.setattr(tool, "train_step", step)
    rc = sup.main(["--max-rss-gb", "0.001", "--",
                   *_argv("conv3d"), "--until-step", "2",
                   "--ckpt", str(tmp_path / "ck"), "--smoke", "--skip-eval",
                   "--device", "cpu"])
    assert rc == 0 and len(commands) == 3
    for i, cmd in enumerate(commands):
        assert cmd[cmd.index("--batch") + 1] == "4", cmd
        assert ("--resume" in cmd) == (i > 0), cmd
    assert images == [4, 4]


# ---------------------------------------------------------------------------
# one TRAIN_BN step, and three harness steps
# ---------------------------------------------------------------------------

def _heads_trained(metrics, where):
    for k in ("mrcnn_bbox_loss", "mrcnn_mask_loss"):
        assert metrics[k] > 0, (where, k)


def _assert_losses(got, ref, spread, where):
    """Every loss within LOSS_TOL of JAX's, relative, or within JAX's
    own spread of it."""
    assert set(got) == set(ref) == set(spread), where
    for k, v in ref.items():
        bar = max(LOSS_TOL * abs(v), spread[k])
        assert abs(got[k] - v) <= bar, (where, k, got[k], v, bar)


def _assert_stats(got, ref, spread, start, where):
    """Every BatchNorm statistic written, and within STAT_TOL of the
    largest magnitude of JAX's or within JAX's own spread."""
    assert set(got) == set(ref) == set(spread) and len(got) > 50, where
    for n, t in got.items():
        assert not torch.equal(t.float(), start[n]), (where, n)   # written
        r = ref[n].double()
        err = float((t.double() - r).abs().max())
        bar = max(STAT_TOL * float(r.abs().max()), spread[n])
        assert err <= bar, (where, n, err, bar)


def _within_spread(got, ref, spread):
    """{name: (error, bar)} of every tensor beyond max(GRAD_TOL of its
    norm, JAX's spread of its norm, 1e-9 of the largest norm). The floor
    is for the conv biases before a batch-statistics BatchNorm: their
    exact gradient is zero and both sides compute float64 rounding noise
    (below 4e-13 of the largest norm), which a nudge moves as far."""
    norms = {n: float(ref[n].double().norm()) for n in got}
    floor = 1e-9 * max(norms.values())
    bad = {}
    for n in got:
        err = float((got[n].double() - ref[n].double()).norm())
        bar = max(GRAD_TOL * norms[n], spread[n], floor)
        if err > bar:
            bad[n] = (err, bar)
    return bad


def test_batch4_train_bn_step_matches_jax(runs):
    port, ref, spread = runs["port"], runs["jax"], runs["spread"]
    where = (runs["mode"], "step 1")
    _heads_trained(port["metrics"][0], where)
    _heads_trained(ref["metrics"][0], where)
    _assert_losses(port["metrics"][0], ref["metrics"][0],
                   spread["metrics"][0], where)
    _assert_stats(port["stats"], ref["stats"], spread["stats"],
                  runs["weights"], where)
    grads = port["grads"]
    assert len(grads) > 100 and set(grads) == set(ref["grads"])
    bad = _within_spread(grads, ref["grads"], spread["grads"])
    assert not bad, bad


def test_batch4_harness_three_steps_match_jax(runs):
    port, ref, spread = runs["port"], runs["jax"], runs["spread"]
    assert len(port["metrics"]) == len(ref["metrics"]) == STEPS
    for i in range(STEPS):
        _assert_losses(port["metrics"][i], ref["metrics"][i],
                       spread["metrics"][i], (runs["mode"], i))
    _assert_stats(port["last_stats"], ref["last_stats"],
                  spread["last_stats"], runs["weights"],
                  (runs["mode"], f"after step {STEPS}"))


def _fresh_table(mode, tmp_path_factory):
    """{"inputs": digest, "spread": JAX's spread} recomputed for `mode`
    (its nudged loop run live)."""
    runs = computed(mode, tmp_path_factory, nudged=True)
    try:
        out = next(runs)
        return {"inputs": out["inputs"],
                "spread": spread(out["jax"], out["nudged"])}
    finally:
        runs.close()


@pytest.mark.slow
@pytest.mark.parametrize("mode", MODES)
def test_batch4_nudge_spread_table_is_current(mode, tmp_path_factory):
    """The committed spread table is what JAX's nudged loop gives now:
    the same inputs, the same quantities, each float within 1e-6 of
    itself (JAX's float64 loop repeats; the bar only absorbs a last-bit
    change of the plain loop it is taken against)."""
    got = _fresh_table(mode, tmp_path_factory)
    want = spread_table()[mode]
    assert got["inputs"] == want["inputs"]
    flat = lambda t: {**{f"metrics{i}.{k}": v for i, m in  # noqa: E731
                         enumerate(t["metrics"]) for k, v in m.items()},
                      **{f"{part}.{k}": v for part in ("stats", "last_stats",
                                                        "grads")
                         for k, v in t[part].items()}}
    got, want = flat(got["spread"]), flat(want["spread"])
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-6, abs=1e-300), k


if __name__ == "__main__":
    # python -m tests.test_torch_train_batch4 [mode ...]: rewrite the
    # spread table's rows for the modes given (default: both)
    import tempfile

    import tests.conftest  # noqa: F401  (the test run's jax settings)

    class _Factory:
        def mktemp(self, name):
            return tempfile.mkdtemp(prefix=name)

    factory = _Factory()
    table = spread_table() if os.path.exists(SPREAD_TABLE) else {}
    for m in sys.argv[1:] or MODES:
        table[m] = _fresh_table(m, factory)
    with open(SPREAD_TABLE, "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")
