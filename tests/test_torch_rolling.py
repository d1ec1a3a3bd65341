"""Rolling dictation in the port (spittle_tpu_torch/text/rolling.py and
app/rolling_session.py) and the port CLI's rolling and catalog
subcommands against the JAX package's on the CPU: every scenario of
tests/data/rolling_scenarios replayed under Perfect and
UnderDeletePerRewrite(1), RollingTranscriber over each package's engine on
the trained tiny checkpoint (tests/data/trained_tiny/params.npz) with one
fake clock, and the two CLIs' stdout."""

import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

from spittle_tpu import cli as jcli
from spittle_tpu.app import rolling_session as j_roll
from spittle_tpu.engine.base import TranscribeParams as JParams
from spittle_tpu.engine.whisper_engine import WhisperEngine as JaxEngine
from spittle_tpu.text import rolling as j_rolling
from spittle_tpu_torch import cli as tcli
from spittle_tpu_torch.app import rolling_session as t_roll
from spittle_tpu_torch.engine.base import TranscribeParams
from spittle_tpu_torch.engine.whisper_engine import WhisperEngine
from spittle_tpu_torch.pipeline import BufferTextOutput
from spittle_tpu_torch.text import rolling as t_rolling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
NPZ = os.path.join(DATA, "trained_tiny", "params.npz")
SCENARIOS = sorted(glob.glob(os.path.join(DATA, "rolling_scenarios", "*.json")))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import train_committed_checkpoint as tcc  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_scenarios_are_there():
    assert len(SCENARIOS) == 4


@pytest.mark.parametrize("path", SCENARIOS, ids=os.path.basename)
@pytest.mark.parametrize("strategy", ["perfect", "under_delete_1"])
def test_scenario_replay(path, strategy):
    reports = []
    for mod in (t_rolling, j_rolling):
        scenario = mod.normalize_scenario(mod.load_scenario(path))
        strat = mod.Perfect() if strategy == "perfect" else mod.UnderDeletePerRewrite(1)
        report = mod.replay_hypotheses(scenario.hypotheses, strat)
        reports.append((vars(scenario), vars(report), mod.run_scenario_file(path)))
    assert reports[0] == reports[1]
    if strategy == "perfect":
        assert reports[0][1]["matches_expected"]


@pytest.mark.parametrize("pair", [("", "Hello"), ("Hello wor", "Hello world."),
                                  ("All right.", "Alright, ok"), ("same", "same")])
def test_rolling_rewrite(pair):
    assert (t_roll.compute_rolling_rewrite(*pair)
            == j_roll.compute_rolling_rewrite(*pair))
    assert (t_rolling.normalize_hypothesis(" " + pair[1] + " , x .")
            == j_rolling.normalize_hypothesis(" " + pair[1] + " , x ."))


def _roll(engine, params, chunks):
    """RollingTranscriber over `engine`, one chunk per fake-clock second.
    Returns the updates, the final text and the window lengths."""
    windows = []
    transcribe = engine.transcribe_samples

    def counted(samples, p=None):
        windows.append(len(samples))
        return transcribe(samples, p)
    engine.transcribe_samples = counted
    mod = t_roll if isinstance(engine, WhisperEngine) else j_roll
    now = [0.0]
    updates = []
    roll = mod.RollingTranscriber(engine, updates.append, params=params,
                                  min_new_audio_s=1.0, min_interval_s=0.5,
                                  clock=lambda: now[0])
    for chunk in chunks:
        now[0] += 1.0
        roll.push_audio(chunk)
    final = roll.finalize()
    return [vars(u) for u in updates], final, windows


def test_rolling_transcriber_matches_the_jax_engine():
    audio = tcc.utterance([4, 2, 3, 0, 4, 3])[0][:4 * 16800]
    chunks = [audio[i:i + 16800] for i in range(0, len(audio), 16800)]
    assert len(chunks) == 4
    kw = dict(language="en", temperatures=(0.0,), max_tokens=32)
    eng = WhisperEngine(device="cpu")
    eng.load_model(NPZ)
    jeng = JaxEngine()
    jeng.load_model(NPZ)
    got = _roll(eng, TranscribeParams(**kw), chunks)
    want = _roll(jeng, JParams(**kw), chunks)
    assert got == want
    updates, final, windows = got
    assert windows == [16800, 33600, 50400, 67200]
    assert final == "this test the hello this the"
    # Each update, typed into a buffer as DELs plus its tail, leaves the
    # buffer equal to that update's hypothesis.
    out = BufferTextOutput()
    for u in updates:
        out.apply_text_diff(0, u["delete_chars"], u["insert"])
        assert out.buffer == u["hypothesis"]


@pytest.mark.parametrize("argv", [["rolling", *SCENARIOS],
                                  ["rolling", "--under-delete", "3", *SCENARIOS],
                                  ["catalog"]], ids=["rolling", "under_delete_3", "catalog"])
def test_cli_matches_the_jax_cli(argv, capsys):
    outs = []
    for main in (tcli.main, jcli.main):
        capsys.readouterr()
        assert main(argv) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and outs[0]
    if argv[0] == "catalog":
        with open(os.path.join(REPO, "spittle_tpu_torch", "config", "data",
                               "model_catalog.json")) as f:
            assert len(outs[0].splitlines()) == len(json.load(f)["models"])
