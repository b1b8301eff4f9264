"""The port's CLI (``lidar-crowd-torch``) against the JAX package's
``lidar-crowd`` on the same inputs, the port on the CPU (``--device cpu``).

Each JAX CLI run happens once per module (``jax_runs``). Held:
- stdout equal line for line with the timing numbers masked;
- the results JSON: integers and strings equal, floats within 1e-5 (as
  ``tests/test_torch_pipeline.py``), within 1e-4 for ``--neural`` (the
  model's tolerance, ``tests/test_torch_neural.py``);
- the SQLite store the port wrote, read by the JAX package's
  ``ResultsStore``, equal to the JAX CLI's under the same tolerances, and
  its stored report equal but for the clock and the engine's name;
- ``train --out``'s checkpoint read and served by the JAX package;
- no run on the CPU unless asked for: without a card the default device
  fails with the pipeline's message; ``degraded`` only under
  ``--fallback-cpu``.
"""

import contextlib
import io
import json
import os
import re

import numpy as np
import pytest
import torch

from lidar_ai_recommendation_software_tpu import cli as jax_cli
from lidar_ai_recommendation_software_tpu.pipeline import (
    Pipeline as JaxPipeline)
from lidar_ai_recommendation_software_tpu.utils.store import (
    ResultsStore as JaxStore)
from lidar_ai_recommendation_software_tpu_torch import cli
from lidar_ai_recommendation_software_tpu_torch.ops.cuda import kernels
from lidar_ai_recommendation_software_tpu_torch.pipeline import Pipeline
from lidar_ai_recommendation_software_tpu_torch.utils import report
from lidar_ai_recommendation_software_tpu_torch.utils import resilience

FLOAT_TOL = 1e-5
NEURAL_TOL = 1e-4
JAX_ENGINE = "the TPU-native LiDAR crowd-analytics engine"

# name -> (arguments after the command, the JSON's float tolerance);
# every run writes its files under its own directory with these names
RUNS = {
    "monolith": (["analyze", "sample", "--json", "out.json", "--report",
                  "out.html", "--no-figures", "--store", "out.sqlite",
                  "--event", "gig"], FLOAT_TOL),
    "modular": (["analyze", "sample", "--variant", "modular", "--json",
                 "out.json", "--store", "out.sqlite"], FLOAT_TOL),
    "neural": (["analyze", "sample", "--neural", "--json", "out.json",
                "--store", "out.sqlite"], NEURAL_TOL),
    "downsample": (["analyze", "sample", "--downsample", "0.5"],
                   FLOAT_TOL),
    "voxel": (["analyze", "sample", "--voxel", "0.4"], FLOAT_TOL),
    "sequence": (["analyze-seq", "f0.npy", "f1.npy", "f2.npy", "--dt",
                  "0.5"], FLOAT_TOL),
}


def _write_frames(directory):
    from lidar_ai_recommendation_software_tpu_torch.synthetic import (
        venue_sequence)
    frames = venue_sequence(n_frames=3, dt=0.5, n_points=8000, n_people=40,
                            extent=20.0, speed=1.2, seed=7)
    for t, f in enumerate(frames):
        np.save(os.path.join(directory, f"f{t}.npy"), f)


def _run(main, argv, directory, pipeline_cls=None):
    """``main(argv)`` inside ``directory`` with numpy's global stream at
    seed 0 (``--downsample`` draws from it): (rc, stdout, the points each
    ``pipeline_cls.analyze`` call was given)."""
    cwd = os.getcwd()
    os.chdir(directory)
    buf = io.StringIO()
    given = []
    if pipeline_cls is not None:
        analyze = pipeline_cls.analyze
        pipeline_cls.analyze = lambda self, pts: (
            given.append(np.array(pts)), analyze(self, pts))[1]
    try:
        np.random.seed(0)
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
    finally:
        os.chdir(cwd)
        if pipeline_cls is not None:
            pipeline_cls.analyze = analyze
    return rc, buf.getvalue(), given


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Each run of ``RUNS`` through the JAX CLI, once: name -> (stdout,
    its directory, the points its pipeline analysed)."""
    out = {}
    for name, (argv, _) in RUNS.items():
        d = tmp_path_factory.mktemp(f"jax_{name}")
        if name == "sequence":
            _write_frames(d)
        rc, text, given = _run(jax_cli.main, argv, d, JaxPipeline)
        assert rc == 0, name
        out[name] = (text, d, given)
    return out


def _mask_timing(text):
    return re.sub(r"in \d+\.\d+s \([\d,]+ pts/s", "in Ts (R pts/s", text)


def _same(got, want, tol, where=""):
    """Integers, strings and structure equal; floats within ``tol``."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), where
        for k in want:
            _same(got[k], want[k], tol, f"{where}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, tol, f"{where}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, (int, float)), where
        assert abs(got - want) <= tol, (where, got, want)
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_cli_matches_the_jax_cli(jax_runs, tmp_path, name):
    argv, tol = RUNS[name]
    if name == "sequence":
        _write_frames(tmp_path)
    rc, text, given = _run(cli.main, argv + ["--device", "cpu"], tmp_path,
                           Pipeline)
    assert rc == 0
    want_text, want_dir, want_given = jax_runs[name]
    assert _mask_timing(text).splitlines() == \
        _mask_timing(want_text).splitlines()
    # the same points reach the analytic pipeline (after --downsample,
    # --voxel; the sequence's last frame)
    assert len(given) == len(want_given) == int(name != "neural")
    for g, w in zip(given, want_given):
        np.testing.assert_array_equal(g, w)
    if "--json" in argv:
        got = json.loads((tmp_path / "out.json").read_text())
        want = json.loads((want_dir / "out.json").read_text())
        _same(got, want, tol)
    if "--store" in argv:
        got_s, want_s = (JaxStore(str(d / "out.sqlite"))
                         for d in (tmp_path, want_dir))
        for s in (got_s, want_s):
            assert [a["id"] for a in s.analyses_for_event(1)] == [1]
        assert got_s.list_events()[0]["name"] == \
            want_s.list_events()[0]["name"]
        for read in ("get_density_results", "get_flow_results",
                     "get_recommendations"):
            _same(getattr(got_s, read)(1), getattr(want_s, read)(1), tol,
                  read)
        reports = [s.list_reports() for s in (got_s, want_s)]
        assert [len(r) for r in reports] == [int("--report" in argv)] * 2
        if "--report" in argv:
            html = [s.get_report(r[0]["id"])["html"]
                    for s, r in zip((got_s, want_s), reports)]
            clock = re.compile(r"\d{4}-\d\d-\d\d \d\d:\d\d:\d\d")
            assert clock.sub("T", html[0]) == clock.sub(
                "T", html[1].replace(JAX_ENGINE, report.ENGINE))
        got_s.close()
        want_s.close()


def test_analyze_pdf_writes_a_real_pdf(tmp_path):
    rc, _, _ = _run(cli.main, ["analyze", "sample", "--pdf", "out.pdf",
                               "--device", "cpu"], tmp_path)
    assert rc == 0
    data = (tmp_path / "out.pdf").read_bytes()
    assert data[:5] == b"%PDF-"
    assert data.count(b"/Type /Page") >= 3


def test_train_writes_a_checkpoint_the_jax_package_serves(tmp_path):
    """``train --out`` at a tiny width: the JAX package's ``NeuralPipeline``
    reads the npz (its parameter tree checked against its own model's
    shapes) and serves what the port's serves from it; the train state
    under ``--orbax-dir`` restores."""
    from lidar_ai_recommendation_software_tpu import neural as jneural
    from lidar_ai_recommendation_software_tpu.synthetic import sample_venue
    from lidar_ai_recommendation_software_tpu_torch import NeuralPipeline
    from lidar_ai_recommendation_software_tpu_torch.models import train

    rc, text, _ = _run(cli.main, [
        "train", "--steps", "2", "--batch-size", "1", "--points", "256",
        "--grid", "8", "--sa1", "32", "--sa2", "8", "--eval-venues", "1",
        "--out", "ckpt.npz", "--orbax-dir", "state", "--device", "cpu"],
        tmp_path)
    assert rc == 0
    assert "final loss" in text and "held-out: density MAE" in text
    ckpt = str(tmp_path / "ckpt.npz")
    cloud = sample_venue(n_points=256, n_people=5, seed=3)
    got = NeuralPipeline(ckpt, device="cpu").analyze(cloud)
    want = jneural.NeuralPipeline(ckpt, use_pallas=False).analyze(cloud)
    assert got["density"]["total_people"] == want["density"]["total_people"]
    np.testing.assert_allclose(got["density"]["density_map"],
                               want["density"]["density_map"],
                               rtol=NEURAL_TOL, atol=NEURAL_TOL)
    np.testing.assert_allclose(got["flow"]["flow_vectors"]["vectors"],
                               want["flow"]["flow_vectors"]["vectors"],
                               rtol=NEURAL_TOL, atol=NEURAL_TOL)
    _, cfg = train.load_params_npz(ckpt)
    assert (cfg.n_points, cfg.grid, cfg.sa1_samples) == (256, 8, 32)
    state = train.restore_checkpoint(
        str(tmp_path / "state" / "train_state.pt"), cfg, device="cpu")
    assert state.step == 2


TRAIN_ARGS = ["train", "--steps", "2", "--batch-size", "2", "--points",
              "256", "--grid", "8", "--sa1", "32", "--sa2", "8",
              "--eval-venues", "1", "--lr", "1e-3", "--seed", "7"]


def _train_numbers(text):
    """The final loss and the held-out density MAE, flow MSE and people
    count error (in percent) that ``train`` prints."""
    loss = re.search(r"final loss (\S+)", text).group(1)
    held = re.search(r"density MAE (\S+) .*flow MSE (\S+), people count "
                     r"rel-err (\S+)%", text).groups()
    return np.array([float(loss), *map(float, held)])


def test_train_matches_the_jax_cli(tmp_path, monkeypatch):
    """Both CLIs' ``train`` on the same options (a learning rate, seed and
    batch size off their defaults): the npz files hold the same
    configuration, and the printed final loss and held-out numbers agree
    within the 1e-4 that ``tests/test_torch_train.py`` allows for later
    losses, plus the half unit of the last printed digit each side rounds.
    The packages draw their first weights from different generators
    (``jax.random.PRNGKey`` against ``torch.Generator``), so the JAX CLI
    starts here from the port's weights for the seed."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from lidar_ai_recommendation_software_tpu.models import train as jtrain
    from lidar_ai_recommendation_software_tpu_torch.models import train

    jax_init = jtrain.init_state

    def init_from_the_port(cfg, rng=None):
        state = jax_init(cfg, rng)
        port = train.init_state(train.TrainConfig(**dataclasses.asdict(cfg)),
                                device="cpu")
        params = train.flax_from_params(port.model.state_dict())
        return jtrain.TrainState.create(
            apply_fn=state.apply_fn, tx=state.tx,
            params=jax.tree_util.tree_map(jnp.asarray, params))

    monkeypatch.setattr(jtrain, "init_state", init_from_the_port)
    rc, want, _ = _run(jax_cli.main, TRAIN_ARGS + ["--out", "jax.npz"],
                       tmp_path)
    assert rc == 0
    rc, got, _ = _run(cli.main, TRAIN_ARGS + ["--out", "port.npz",
                                               "--device", "cpu"], tmp_path)
    assert rc == 0
    cfgs = [json.loads(str(np.load(tmp_path / name)["config_json"]))
            for name in ("jax.npz", "port.npz")]
    assert cfgs[0] == cfgs[1]
    assert (cfgs[1]["learning_rate"], cfgs[1]["seed"],
            cfgs[1]["batch_size"], cfgs[1]["bf16"]) == (1e-3, 7, 2, False)
    g, w = _train_numbers(got), _train_numbers(want)
    printed = np.array([1e-4, 1e-4, 1e-4, 0.1])  # a unit of the last digit
    assert np.all(np.abs(g - w) <= 1e-4 * np.abs(w) + printed), (g, w)


NO_CARD_RUNS = {
    "analyze": ["analyze", "sample"],
    "neural": ["analyze", "sample", "--neural"],
    "fallback": ["analyze", "sample", "--fallback-cpu"],
    "sequence": ["analyze-seq", "sample", "sample"],
    "bench": ["bench", "--points", "2000"],
    "train": ["train", "--steps", "1"],
}


@pytest.mark.parametrize("name", sorted(NO_CARD_RUNS))
def test_no_card_means_no_silent_cpu_run(name, capsys):
    """Without ``--device cpu`` every command that runs the analytics asks
    for the card, and without one fails with the pipeline's message
    before it prints a result; ``--fallback-cpu`` does not cover a missing
    device."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match=r"needs a CUDA device .* pass "
                                           r"device='cpu'"):
        cli.main(NO_CARD_RUNS[name])
    assert "people detected" not in capsys.readouterr().out


@pytest.fixture
def card_fails_once(monkeypatch):
    """``Pipeline.analyze`` raises on its first call and the device stops
    answering the health probe, as a card lost under the first pipeline
    would; the pipeline runs after that."""
    analyze = Pipeline.analyze
    calls = []

    def fails_once(self, points):
        calls.append(self.device)
        if len(calls) == 1:
            raise RuntimeError("simulated device loss")
        return analyze(self, points)

    def lost(device):
        return False

    monkeypatch.setattr(Pipeline, "analyze", fails_once)
    monkeypatch.setattr(resilience, "device_answers_in_subprocess", lost)
    return calls


@pytest.fixture
def kernel_build_fails(monkeypatch):
    """The kernels are built at their first launch, inside
    ``Pipeline.analyze`` (``kernels.load_library``); here that build fails
    while the device answers the health probe."""
    def nvcc_fails():
        raise RuntimeError("nvcc failed (1): simulated")

    def first_launch(self, points):
        kernels.load_library()

    monkeypatch.setattr(kernels, "load_library", nvcc_fails)
    monkeypatch.setattr(Pipeline, "analyze", first_launch)


def test_fallback_cpu_degrades_to_the_ports_cpu_pipeline(
        card_fails_once, tmp_path, capsys):
    """``analyze --fallback-cpu``: the pipeline's failure degrades to the
    port's own pipeline on the CPU, with the JAX CLI's warning."""
    rc = cli.main(["analyze", "sample", "--fallback-cpu", "--device",
                   "cpu"])
    assert rc == 0
    cap = capsys.readouterr()
    assert "people detected : 446" in cap.out
    assert "CPU oracle fallback" in cap.err
    assert [d.type for d in card_fails_once] == ["cpu", "cpu"]


def test_no_fallback_without_the_option(card_fails_once, capsys):
    with pytest.raises(RuntimeError, match="simulated device loss"):
        cli.main(["analyze", "sample", "--device", "cpu"])
    assert "people detected" not in capsys.readouterr().out


def test_fallback_cpu_raises_a_kernel_fault_on_a_healthy_device(
        kernel_build_fails, capsys):
    """``--fallback-cpu`` degrades only when the device is lost: a kernel
    that does not build on a device that answers the probe is raised,
    never answered from the CPU."""
    assert resilience.device_healthy(attempts=1, device="cpu")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cli.main(["analyze", "sample", "--fallback-cpu", "--device", "cpu"])
    cap = capsys.readouterr()
    assert "people detected" not in cap.out
    assert "fallback" not in cap.err
