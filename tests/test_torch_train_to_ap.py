"""The port's quality harness (cli/train_to_ap.py, cli/train_supervisor.py)
against the JAX tools (tools/train_to_ap.py, tools/train_supervisor.py)
on the CPU, at 64^2, --nvox 8 --samples 2 --scenes 2 --grid-reas add.

* The config equals the JAX tool's, key for key; the NMS protocol
  ceiling equals JAX's (0.75 and 1.0 on the 640^2 scenes of
  tests/test_data.py).
* The learning rate of every update equals the optax rate the JAX tool
  applies, to 1e-6 relative (optax computes the schedule in float32),
  with and without --warmup, fresh, resumed and in --until-step
  segments across the drop; and the momentum is empty at the same
  updates (right after the drop without --warmup). Both tools run
  their own main() with the model, the batch and the step replaced by
  stubs that record the rate of the update they apply: what runs is
  each tool's optimizer logic and its checkpoints.
* `evaluate` and `diagnose` with JAX-initialised weights carried across
  by utils/convert.py give JAX's AP (to the 4 digits its result
  rounds to), its per-scene number of
  detections and its proposal recall exactly, with --min-conf 0; and
  with one stub engine (the ground truth with a box dropped, a mask
  eroded, a spurious detection) the whole diagnostics dict equals JAX's.
* The held-out fields and the cumulative seconds across segments (the
  history sidecar with a partial last line) as tests/test_holdout.py
  holds the JAX tool to them; the supervisor's contract as
  tests/test_supervisor.py holds the JAX supervisor to it, and a
  segmented --warmup run restored across the drop.
* `init_weights` gives each parameter the spread of flax's init of the
  same configuration: the standard deviation within 10% for every
  tensor of at least 1000 elements (the sample standard deviation of n
  draws is within 1/sqrt(2n) = 2.2% of the true one there), and for the
  smaller tensors over the pool of the tensors of one shape when it has
  at least 500 elements; zeros and ones exactly where flax has them.
* A one-step --smoke run with jax, flax, optax and the JAX package
  made unimportable.
"""

import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

import mulit_view_object_detection_tpu.compat.model as jcompat  # noqa: E402
import mulit_view_object_detection_tpu.data.generator as jgenerator  # noqa: E402
import mulit_view_object_detection_tpu.models.detector as jdetector  # noqa: E402
import mulit_view_object_detection_tpu.train.step as jstep  # noqa: E402
from mulit_view_object_detection_tpu.data.generator import (  # noqa: E402
    load_image_gt as jax_load_image_gt, make_batch as jax_make_batch)
from mulit_view_object_detection_tpu.data.synthetic import (  # noqa: E402
    SyntheticMultiViewDataset as JaxSynthetic)
from mulit_view_object_detection_tpu.ops.boxes import (  # noqa: E402
    norm_boxes_np as jax_norm_boxes_np)
from mulit_view_object_detection_tpu.train.optim import (  # noqa: E402
    make_optimizer as jax_make_optimizer)
from mulit_view_object_detection_torch.cli import (  # noqa: E402
    train_supervisor as sup, train_to_ap as tool)
from mulit_view_object_detection_torch.compat import MaskRCNN  # noqa: E402
from mulit_view_object_detection_torch.data.generator import (  # noqa: E402
    load_image_gt)
from mulit_view_object_detection_torch.data.synthetic import (  # noqa: E402
    SyntheticMultiViewDataset)
from mulit_view_object_detection_torch.ops.boxes import (  # noqa: E402
    norm_boxes_np)
from mulit_view_object_detection_torch.train.optim import (  # noqa: E402
    warmup_schedule)
from mulit_view_object_detection_torch.utils.convert import (  # noqa: E402
    torch_to_flax)
from tools import train_to_ap as jax_tool  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--image-size", "64", "--nvox", "8", "--samples", "2",
         "--scenes", "2", "--grid-reas", "add"]
PORT = SMALL + ["--device", "cpu"]
LR = 0.002


# ---------------------------------------------------------------------------
# a) config, b) NMS ceiling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size,variant,kwargs", [
    (64, "conv3d", {}),
    (640, "conv3d", {}),
    (64, "xformer", {}),
    (640, "xformer", {}),
    (640, "xformer", {"xformer_arch": "6,8,256"}),
    (64, "conv3d", {"nvox_override": 8, "samples_override": 2,
                    "grid_reas": "lstm3d"}),
])
def test_build_config_matches_jax(size, variant, kwargs):
    want = jax_tool.build_config(size, 2, variant, **kwargs).to_dict()
    got = tool.build_config(size, 2, variant, **kwargs).to_dict()
    assert sorted(got) == sorted(want)
    np.testing.assert_equal(got, want)


def test_nms_ap_ceiling_matches_jax():
    kw = dict(num_scenes=4, num_views=2, image_size=640, num_classes=4,
              seed=1, obj_px_range=(180.0, 380.0))
    jds, ds = JaxSynthetic(**kw), SyntheticMultiViewDataset(**kw)
    for thr, want in ((0.3, 0.75), (0.55, 1.0)):
        cfg = types.SimpleNamespace(DETECTION_NMS_THRESHOLD=thr)
        assert jax_tool._nms_ap_ceiling(jds, cfg) == want
        assert tool._nms_ap_ceiling(ds, cfg) == want


# ---------------------------------------------------------------------------
# c) the learning rate of every update, and the momentum resets
# ---------------------------------------------------------------------------

def _trace(opt_state):
    """The momentum trace inside the JAX tool's optax chain state."""
    if hasattr(opt_state, "trace"):
        return opt_state.trace
    if isinstance(opt_state, tuple):
        for s in opt_state:
            t = _trace(s)
            if t is not None:
                return t
    return None


def _stub_jax(monkeypatch, seen):
    """The JAX tool with a 3-element model: its main() runs its optimizer
    logic and orbax checkpoints; the step records (rate, momentum empty)
    of each update it applies with a gradient of ones."""

    def create_train_state(model, cfg, rng, batch):
        params = {"w": jnp.zeros(3, jnp.float32)}
        tx = jax_make_optimizer(cfg.LEARNING_RATE,
                                cfg.LEARNING_MOMENTUM,
                                cfg.GRADIENT_CLIP_NORM)
        return jstep.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                batch_stats={}, opt_state=tx.init(params),
                                tx=tx, apply_fn=None)

    def make_train_step(cfg, stage="all", donate=False):
        def step(state, batch, rng):
            empty = not bool(jnp.any(_trace(state.opt_state)["w"] != 0))
            grads = {"w": jnp.ones(3, jnp.float32)}
            updates, opt = state.tx.update(grads, state.opt_state,
                                           state.params)
            trace = _trace(opt)["w"]
            seen.append((float(-updates["w"][0] / trace[0]), empty))
            return (state.replace(params=optax.apply_updates(state.params,
                                                             updates),
                                  opt_state=opt),
                    {"loss": jnp.float32(1.0)})
        return step

    class Engine:
        def __init__(self, *a, **k):
            pass

        def _ensure_state(self):
            pass

    monkeypatch.setattr(jstep, "create_train_state", create_train_state)
    monkeypatch.setattr(jstep, "make_train_step", make_train_step)
    monkeypatch.setattr(jcompat, "MaskRCNN", Engine)
    monkeypatch.setattr(jgenerator, "make_batch", lambda *a, **k: {})
    monkeypatch.setattr(jdetector, "MaskRCNN", lambda cfg: None)


class _Tiny(torch.nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(3))

    def init_weights(self, generator):
        pass


def _stub_port(monkeypatch, seen):
    """The port's tool with the same 3-element model; the step records
    (rate, momentum empty) and applies a gradient of ones."""

    def train_step(model, optimizer, batch, cfg, mask, generator):
        empty = not any(optimizer.state.get(p, {}).get("momentum_buffer")
                        is not None for p in model.parameters())
        seen.append((optimizer.param_groups[0]["lr"], empty))
        for p in model.parameters():
            p.grad = torch.ones_like(p)
        optimizer.step()
        return {"loss": 1.0}

    monkeypatch.setattr(tool, "Model", _Tiny)
    monkeypatch.setattr(tool, "make_batch", lambda *a, **k: {})
    monkeypatch.setattr(tool, "train_step", train_step)
    monkeypatch.setattr(tool, "trainable_mask", lambda model, stage: {
        n: True for n, _ in model.named_parameters()})


def _segments(main, segments):
    """Run main() on each argv; an exit 75 ends a segment."""
    for argv in segments:
        try:
            main(argv)
        except SystemExit as e:
            assert e.code == 75, e.code


def _schedule_case(name, ckpt):
    common = SMALL + ["--smoke", "--skip-eval"]
    rss = ["--ckpt", ckpt, "--max-rss-gb", "0.001"]
    cases = {
        "fresh": [["--steps", "8"]],
        "fresh_warmup": [["--steps", "8", "--warmup", "3"]],
        "resumed": [["--steps", "4", "--ckpt", ckpt],
                    ["--steps", "4", "--ckpt", ckpt, "--resume"],
                    ["--steps", "4", "--ckpt", ckpt, "--resume",
                     "--lr-drop", "0.5"]],
        "resumed_warmup": [["--steps", "4", "--warmup", "3", "--ckpt", ckpt],
                           ["--steps", "4", "--warmup", "3", "--ckpt", ckpt,
                            "--resume"]],
        # one-step segments (the RSS budget trips at the step-0 check)
        "until_step": [["--until-step", "6"] + rss + (["--resume"] if i
                                                       else [])
                       for i in range(7)],
        "until_step_warmup": [["--until-step", "6", "--warmup", "2"] + rss
                              + (["--resume"] if i else [])
                              for i in range(7)],
    }
    return [common + argv for argv in cases[name]]


# the rates a reader expects (LR/10 at the drop, momentum reset there
# without warmup; a resumed run without --lr-drop at full LR; segments
# past the until-step boundary each rebuilding the optimizer)
EXPECTED = {
    "fresh": [(LR, True)] + [(LR, False)] * 5 + [(LR / 10, True),
                                                  (LR / 10, False)],
    "fresh_warmup": [(0.0, True), (LR / 3, False), (2 * LR / 3, False),
                     (LR, False), (LR, False), (LR, False),
                     (LR / 10, False), (LR / 10, False)],
    "until_step": [(LR, True)] + [(LR, False)] * 3 + [(LR / 10, True)] * 2,
    "until_step_warmup": [(0.0, True), (LR / 2, False), (LR, False),
                          (LR, False), (LR / 10, False), (LR / 10, False)],
}


@pytest.mark.parametrize("name", ["fresh", "fresh_warmup", "resumed",
                                  "resumed_warmup", "until_step",
                                  "until_step_warmup"])
def test_learning_rate_matches_optax(name, monkeypatch, tmp_path):
    jseen, seen = [], []
    with monkeypatch.context() as m:
        _stub_jax(m, jseen)
        _segments(jax_tool.main, _schedule_case(name, str(tmp_path / "j")))
    _stub_port(monkeypatch, seen)
    _segments(tool.main, [a + ["--device", "cpu"] for a in
                          _schedule_case(name, str(tmp_path / "t"))])
    assert len(seen) == len(jseen) > 0
    for i, ((lr, empty), (jlr, jempty)) in enumerate(zip(seen, jseen)):
        assert lr == pytest.approx(jlr, rel=1e-6, abs=1e-12), (i, seen, jseen)
        assert empty == jempty, (i, seen, jseen)
    if name in EXPECTED:
        assert [e for _, e in seen] == [e for _, e in EXPECTED[name]]
        np.testing.assert_allclose([r for r, _ in seen],
                                   [r for r, _ in EXPECTED[name]],
                                   rtol=1e-6)


def test_warmup_schedule_is_optax():
    """train/optim.py::warmup_schedule against optax's linear_schedule
    joined with a constant at every step, drop and no drop."""
    for warmup, drop in ((3, 6), (5, 0), (4, 2)):
        sched = optax.linear_schedule(0.0, LR, warmup)
        if drop:
            sched = optax.join_schedules(
                [sched, optax.constant_schedule(LR / 10)], [drop])
        fn = warmup_schedule(LR, warmup, drop)
        for s in range(12):
            assert fn(s) == pytest.approx(float(sched(s)), rel=1e-6,
                                          abs=1e-12), (warmup, drop, s)


# ---------------------------------------------------------------------------
# d) evaluate and diagnose against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flax_init():
    """flax's init of the test configuration (the JAX tool's
    create_train_state draws it the same way) and that config."""
    cfg = jax_tool.build_config(64, 2, nvox_override=8, samples_override=2,
                                grid_reas="add")
    ds = JaxSynthetic(num_scenes=2, num_views=2, image_size=64,
                      num_classes=4, seed=1)
    batch = jax_make_batch(ds, cfg, rnd_state=0)
    model = jdetector.MaskRCNN(cfg)
    key = jax.random.PRNGKey(1)
    rngs = {"params": key, "sampling": jax.random.fold_in(key, 1),
            "dropout": jax.random.fold_in(key, 2)}
    variables = jax.jit(lambda r, b: model.init(r, b, training=True))(
        rngs, batch)
    return jax.tree_util.tree_map(np.asarray, dict(variables))


def _jax_with_weights(monkeypatch, variables):
    """The JAX tool's main() with its training state and its engine's
    state holding `variables` (no init)."""

    def state(apply_fn=None):
        return jstep.TrainState(step=0, params=variables["params"],
                                batch_stats=variables["batch_stats"],
                                opt_state=None, tx=None, apply_fn=apply_fn)

    def ensure(self):
        if self._state is None:
            self._state = state(self.model.apply)
        return self._state

    monkeypatch.setattr(jstep, "create_train_state",
                        lambda model, cfg, rng, batch: state())
    monkeypatch.setattr(jcompat.MaskRCNN, "_ensure_state", ensure)


def _port_engine(args, variables=None):
    cfg = tool.eval_config(tool.train_config(args), args)
    eng = MaskRCNN("inference", cfg, "unused", device="cpu")
    if variables is not None:
        eng.load_flax_variables(variables)
    return eng, cfg


def test_evaluate_and_diagnose_match_jax(flax_init, monkeypatch):
    argv = SMALL + ["--steps", "0", "--min-conf", "0", "--diagnostics",
                    "--smoke"]
    with monkeypatch.context() as m:
        _jax_with_weights(m, flax_init)
        ref = jax_tool.main(argv)
    args = tool.make_parser().parse_args(argv + ["--device", "cpu"])
    eng, cfg = _port_engine(args, flax_init)
    ds = tool.make_dataset(args, args.scenes, args.seed)
    ap = tool.evaluate(eng, ds, cfg, args)
    diag = tool.diagnose(eng, ds, cfg, args)
    assert round(ap, 4) == ref["ap50"]
    want = ref["diagnostics"]
    assert [s["n_det"] for s in diag["per_scene"]] == \
        [s["n_det"] for s in want["per_scene"]]
    assert sum(s["n_det"] for s in diag["per_scene"]) > 0
    for k in ("proposal_recall50", "mask_ap50", "box_ap50",
              "mean_detections", "nms_protocol_ap_ceiling"):
        assert diag[k] == want[k], (k, diag[k], want[k])


class _StubEngine:
    """detect() returns the main view's ground truth with its first box
    dropped, its second mask eroded to a corner and one spurious
    detection; run_graph()'s proposals are the ground truth boxes but
    the first. The scene is found by its main view's pixels."""

    def __init__(self, dataset, config, load_gt, norm_boxes):
        self.by_image = {}
        for key in dataset.view_map:
            main = dataset.load_view(5, key, rnd_state=0)[0]
            self.by_image[dataset.load_image(main).tobytes()] = \
                load_gt(dataset, config, main, use_mini_mask=False)[2:]
        self.norm_boxes = norm_boxes
        self._state = types.SimpleNamespace(replace=lambda **k: self._state)

    def _ensure_state(self):
        return self._state

    def _gt(self, images):
        return self.by_image[np.asarray(images[0])[0].tobytes()]

    def detect(self, images, Rcam=None, Kmat=None, depths=None):
        cls, boxes, masks = self._gt(images)
        masks = masks.copy()
        if masks.shape[-1] > 1:
            y, x = boxes[1, :2]
            masks[:, :, 1] = False
            masks[y:y + 2, x:x + 2, 1] = True
        spurious = np.zeros(masks.shape[:2] + (1,), bool)
        spurious[:6, :6] = True
        rois = np.concatenate([boxes[1:], [[0, 0, 6, 6]]]).astype(np.int32)
        return [{"rois": rois,
                 "class_ids": np.concatenate([cls[1:], cls[:1]]),
                 "scores": np.linspace(0.95, 0.55, len(cls)),
                 "masks": np.concatenate([masks[..., 1:], spurious], -1)}]

    def run_graph(self, images, outputs=None, Rcam=None, Kmat=None,
                  depths=None):
        _, boxes, _ = self._gt(images)
        return {"proposals": self.norm_boxes(
            boxes[1:].astype(np.float32), (64, 64))[None]}


def test_diagnostics_match_jax_on_one_stub_engine(monkeypatch):
    argv = SMALL + ["--steps", "0", "--diagnostics", "--smoke"]
    args = tool.make_parser().parse_args(argv + ["--device", "cpu"])
    cfg = tool.eval_config(tool.train_config(args), args)
    with monkeypatch.context() as m:
        jds = JaxSynthetic(num_scenes=2, num_views=2, image_size=64,
                           num_classes=4, seed=1)
        jcfg = jax_tool.build_config(64, 2, nvox_override=8,
                                     samples_override=2, grid_reas="add")
        stub = _StubEngine(jds, jcfg, jax_load_image_gt, jax_norm_boxes_np)
        m.setattr(jcompat, "MaskRCNN", lambda *a, **k: stub)
        m.setattr(jstep, "create_train_state", lambda *a: types.
                  SimpleNamespace(params=None, batch_stats=None))
        ref = jax_tool.main(argv)
    ds = tool.make_dataset(args, args.scenes, args.seed)
    eng = _StubEngine(ds, cfg, load_image_gt, norm_boxes_np)
    ap = tool.evaluate(eng, ds, cfg, args)
    diag = tool.diagnose(eng, ds, cfg, args)
    assert round(ap, 4) == ref["ap50"]
    assert 0.0 < ap < 1.0
    assert diag == ref["diagnostics"]
    assert 0.0 < diag["proposal_recall50"] < 1.0
    assert any(s["missed"] for s in diag["per_scene"])
    assert any(s["false_pos"] for s in diag["per_scene"])


# ---------------------------------------------------------------------------
# e) held-out fields, cumulative seconds
# ---------------------------------------------------------------------------

def test_train_to_ap_holdout_fields(tmp_path):
    out = str(tmp_path / "r.json")
    result = tool.main(PORT + [
        "--steps", "1", "--holdout-scenes", "1", "--holdout-view-seed", "9",
        "--smoke", "--out", out])
    assert "train scenes" in result["ap50_eval_scope"]
    assert 0.0 <= result["holdout_scene_ap50"] <= 1.0
    assert 0.0 <= result["holdout_view_ap50"] <= 1.0
    assert result["holdout_scenes"] == 1
    assert result["holdout_seed"] == result["seed"] + 1000
    assert result["holdout_view_seed"] == 9
    assert 0.0 < result["holdout_scene_nms_ceiling"] <= 1.0
    assert result["backend"] == "cpu"
    assert set(result["device"]) == {"name", "power_limit"}
    assert os.path.exists(out)


def test_result_keys_are_jax_keys_and_device(tmp_path, monkeypatch):
    """The same result keys as the JAX tool's on the same run (JAX's
    with its state and engine stubbed), plus "device"."""
    argv = SMALL + ["--steps", "0", "--skip-eval", "--smoke",
                    "--holdout-scenes", "1"]
    with monkeypatch.context() as m:
        _stub_jax(m, [])
        ref = jax_tool.main(argv)
    _stub_port(monkeypatch, [])
    got = tool.main(argv + ["--device", "cpu"])
    assert set(got) == set(ref) | {"device"}


def test_cumulative_seconds_across_segments(tmp_path):
    ckpt = str(tmp_path / "ck")
    common = PORT + ["--ckpt", ckpt, "--smoke", "--skip-eval"]
    first = tool.main(common + ["--steps", "2"])
    # a segment killed mid-append leaves a partial last line
    with open(ckpt + "_history.jsonl", "a") as f:
        f.write('{"segment_seconds": 12')
    result = tool.main(common + ["--steps", "2", "--resume"])
    assert result["steps"] == 4
    assert result["cumulative_seconds"] > 0
    # both segments' seconds (each rounded to 0.1 s), the partial line
    # skipped and the entry after it kept
    assert abs(result["cumulative_seconds"]
               - (first["seconds"] + result["seconds"])) <= 0.11
    assert "sum of all segments" in result["cumulative_seconds_scope"]
    assert result["seconds_scope"].startswith("final segment only")
    # an --eval-only run reports the checkpoint's step (it trains none)
    result = tool.main(common + ["--steps", "2", "--eval-only"])
    assert result["steps"] == 4 and result["final_loss"] is None


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tool.main(SMALL + ["--steps", "1", "--smoke"])


# ---------------------------------------------------------------------------
# f) the supervisor
# ---------------------------------------------------------------------------

def _run(monkeypatch, rcs, argv):
    calls = []

    def fake_call(cmd, env=None):
        calls.append((cmd, env))
        return rcs[len(calls) - 1]

    monkeypatch.setattr(sup.subprocess, "call", fake_call)
    rc = sup.main(argv)
    return rc, [c for c, _ in calls], [e for _, e in calls]


def test_supervisor_single_segment_success(monkeypatch):
    rc, calls, envs = _run(monkeypatch, [0], [
        "--max-rss-gb", "55", "--",
        "--steps", "10", "--until-step", "10", "--ckpt", "/tmp/x"])
    assert rc == 0
    assert len(calls) == 1
    assert calls[0][-2:] == ["--max-rss-gb", "55.0"]
    assert "--resume" not in calls[0]
    assert calls[0][1:3] == ["-m",
                             "mulit_view_object_detection_torch.cli."
                             "train_to_ap"]
    # the child finds the package wherever it is started
    assert envs[0]["PYTHONPATH"].split(os.pathsep)[0] == ROOT


def test_supervisor_exit75_relaunches_with_resume(monkeypatch):
    rc, calls, _ = _run(monkeypatch, [75, 75, 0], [
        "--", "--steps", "10", "--until-step", "10", "--ckpt", "/tmp/x"])
    assert rc == 0
    assert len(calls) == 3
    assert "--resume" not in calls[0]
    assert calls[1].count("--resume") == 1
    assert calls[2].count("--resume") == 1


def test_supervisor_nonrestart_failure_propagates(monkeypatch):
    rc, calls, _ = _run(monkeypatch, [75, 1], [
        "--", "--steps", "10", "--until-step", "10", "--ckpt", "/tmp/x"])
    assert rc == 1
    assert len(calls) == 2


def test_supervisor_restart_cap(monkeypatch):
    rc, calls, _ = _run(monkeypatch, [75] * 3, [
        "--max-restarts", "2", "--",
        "--steps", "10", "--until-step", "10", "--ckpt", "/tmp/x"])
    assert rc == 1
    assert len(calls) == 3


@pytest.mark.parametrize("argv", [
    ["--", "--steps", "10"],                           # no --ckpt
    ["--", "--steps", "10", "--ckpt", "/tmp/x"],       # no --until-step
])
def test_supervisor_requires_ckpt_and_until_step(argv):
    with pytest.raises(SystemExit):
        sup.main(argv)


def test_supervisor_explicit_resume_not_duplicated(monkeypatch):
    rc, calls, _ = _run(monkeypatch, [75, 0], [
        "--", "--steps", "10", "--until-step", "10", "--ckpt", "/tmp/x",
        "--resume"])
    assert rc == 0
    assert calls[1].count("--resume") == 1


def test_supervisor_accepts_equals_form_flags(monkeypatch):
    rc, calls, _ = _run(monkeypatch, [0], [
        "--", "--steps", "10", "--until-step=10", "--ckpt=/tmp/x"])
    assert rc == 0 and len(calls) == 1


def test_warmup_segmented_restore_across_the_drop(tmp_path):
    """Real one-step segments with --warmup, each exiting 75, restored
    into the same optimizer across the drop (step 2 of 3); the last
    segment finds nothing left to run."""
    ckpt = str(tmp_path / "ck")
    common = PORT + ["--steps", "999", "--until-step", "3", "--warmup", "1",
                     "--ckpt", ckpt, "--max-rss-gb", "0.001", "--smoke",
                     "--skip-eval"]
    for seg in range(3):
        with pytest.raises(SystemExit) as e:
            tool.main(common + (["--resume"] if seg else []))
        assert e.value.code == 75
    result = tool.main(common + ["--resume"])
    assert result["steps"] == 3
    assert result["cumulative_seconds"] > 0


# ---------------------------------------------------------------------------
# g) init spread
# ---------------------------------------------------------------------------

def test_init_weights_spread_matches_flax(flax_init):
    cfg = tool.build_config(64, 2, nvox_override=8, samples_override=2,
                            grid_reas="add")
    model = tool.Model(cfg)
    model.init_weights(torch.Generator().manual_seed(1))
    ours = flatten_dict(torch_to_flax(
        {k: v.detach() for k, v in model.state_dict().items()}))
    ref = flatten_dict(flax_init)
    assert set(ours) == set(ref)
    pools = {}
    for k, want in ref.items():
        want, got = np.asarray(want), np.asarray(ours[k])
        assert got.shape == want.shape, k
        for const in (0.0, 1.0):
            if np.all(want == const):
                assert np.all(got == const), k
        if want.std() == 0:
            continue
        if want.size >= 1000:
            assert abs(got.std() / want.std() - 1) <= 0.1, (
                k, got.std(), want.std())
        else:
            a, b = pools.setdefault(want.shape, ([], []))
            a.append(want.ravel())
            b.append(got.ravel())
    for shape, (a, b) in pools.items():
        a, b = np.concatenate(a), np.concatenate(b)
        if a.size >= 500:
            assert abs(b.std() / a.std() - 1) <= 0.1, (shape, b.std(),
                                                       a.std())


# ---------------------------------------------------------------------------
# h) without jax
# ---------------------------------------------------------------------------

def test_harness_runs_with_jax_blocked(tmp_path):
    """With jax, flax, optax and the JAX package unimportable, one
    --smoke step, its evaluation and a checkpoint."""
    code = f"""
import importlib.abc
import sys
BLOCKED = ("jax", "jaxlib", "flax", "optax", "mulit_view_object_detection_tpu")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import torch
torch.set_num_threads(1)
from mulit_view_object_detection_torch.cli import train_to_ap
r = train_to_ap.main({PORT!r} + ["--steps", "1", "--smoke",
                     "--ckpt", {str(tmp_path / "ck")!r}])
assert r["steps"] == 1 and r["final_loss"] is not None
bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not bad, bad
print("HARNESS_RAN")
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "HARNESS_RAN" in proc.stdout
