"""The port's CLI (spittle_tpu_torch/cli.py), WhisperEngine.from_env and
engine factory (spittle_tpu_torch/engine/factory.py) against the JAX
package's: the CLIs' stdout on the trained tiny checkpoint
(tests/data/trained_tiny/params.npz, which both loaders read; `random:`
weights differ between the packages) for transcribe and vad on one WAV,
the parsers' flags, from_env's options and errors under every
SPITTLE_QUANTIZE_DECODER value, the factory's classes and draft, and the
JAX app's TranscriptionManager transcribing through the port's factory.

The JAX CLI is called four times (three transcribe flag sets and vad).
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from spittle_tpu import cli as jcli
from spittle_tpu.engine.whisper_engine import WhisperEngine as JaxEngine
from spittle_tpu_torch import cli as tcli
from spittle_tpu_torch.audio.resample import resample
from spittle_tpu_torch.audio.wav import save_wav_file
from spittle_tpu_torch.engine import factory
from spittle_tpu_torch.engine.base import TranscribeParams
from spittle_tpu_torch.engine.moonshine_engine import MoonshineEngine
from spittle_tpu_torch.engine.parakeet_engine import ParakeetEngine
from spittle_tpu_torch.engine.sensevoice_engine import SenseVoiceEngine
from spittle_tpu_torch.engine.whisper_engine import WhisperEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, "tests", "data", "trained_tiny", "params.npz")
sys.path.insert(0, os.path.join(REPO, "scripts"))
import train_committed_checkpoint as tcc  # noqa: E402

ENV_KEYS = ("SPITTLE_QUANTIZE_DECODER", "SPITTLE_QUANTIZE_ENCODER",
            "SPITTLE_QUANTIZE_CACHE", "SPITTLE_WIRE", "SPITTLE_DRAFT_MODEL")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)


def _audio() -> np.ndarray:
    """38 s: a trained-tiny utterance window, then 8 s of a second one."""
    return np.concatenate([tcc.utterance([4, 2, 3, 0])[0],
                           tcc.utterance([1, 5, 6])[0][:8 * 16000]])


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    audio = _audio()
    path16 = str(d / "a.wav")
    save_wav_file(path16, audio)
    # The same audio at 22.05 kHz, for the resampling path.
    path22 = str(d / "a22.wav")
    save_wav_file(path22, resample(torch.from_numpy(audio), 16000, 22050).numpy(),
                  22050)
    return path16, path22


def _stdout(main, argv, capsys):
    capsys.readouterr()
    assert main(argv) == 0
    return capsys.readouterr().out


TRANSCRIBE_FLAGS = {
    "plain": [],
    "parallel_timestamps": ["--parallel-windows", "--timestamps"],
    "audio_ctx": ["--parallel-windows", "--audio-ctx", "750"],
}


@pytest.mark.parametrize("flags", sorted(TRANSCRIBE_FLAGS))
def test_transcribe_prints_what_the_jax_cli_prints(wavs, capsys, flags):
    argv = ["transcribe", wavs[0], "--model", NPZ] + TRANSCRIBE_FLAGS[flags]
    want = _stdout(jcli.main, argv, capsys)
    got = _stdout(tcli.main, argv + ["--torch-device", "cpu"], capsys)
    assert got == want
    assert want.strip()


def test_vad_prints_what_the_jax_cli_prints(wavs, capsys):
    want = _stdout(jcli.main, ["vad", wavs[0]], capsys)
    got = _stdout(tcli.main, ["vad", wavs[0], "--torch-device", "cpu"], capsys)
    assert got == want
    assert "segments" in want


def test_transcribe_resamples_on_its_device(wavs, capsys):
    """A 22.05 kHz file: the CLI's text and segments equal the engine's on
    the port's own resampling of the same PCM."""
    from spittle_tpu_torch.audio.wav import load_wav_file

    got = _stdout(tcli.main, ["transcribe", wavs[1], "--model", NPZ,
                              "--parallel-windows", "--timestamps",
                              "--torch-device", "cpu"], capsys)
    pcm, rate = load_wav_file(wavs[1])
    audio = resample(torch.from_numpy(pcm), rate, 16000).numpy()
    eng = WhisperEngine(device="cpu")
    eng.load_model(NPZ)
    res = eng.transcribe_samples(audio, TranscribeParams(
        parallel_windows=True, condition_on_previous_text=False))
    want = [res.text] + [f"[{s.start:7.2f} -> {s.end:7.2f}] {s.text}"
                         for s in res.segments]
    assert got.splitlines() == want


def test_module_entry_point(wavs, capsys):
    """python -m spittle_tpu_torch.cli prints what main() prints."""
    argv = ["transcribe", wavs[0], "--model", NPZ, "--parallel-windows",
            "--torch-device", "cpu"]
    want = _stdout(tcli.main, argv, capsys)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "spittle_tpu_torch.cli"] + argv,
                         cwd=REPO, capture_output=True, text=True, timeout=120,
                         env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout == want


def test_cli_defaults_to_the_card(wavs):
    args = tcli.build_parser().parse_args(["transcribe", wavs[0]])
    assert args.torch_device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(["transcribe", wavs[0], "--model", NPZ])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(["vad", wavs[0]])


def _flags(parser):
    """{subcommand: {flag or positional dest: (dest, default, const, nargs,
    choices, type, action)}}."""
    subs = next(a for a in parser._actions
                if a.__class__.__name__ == "_SubParsersAction")
    out = {}
    for name, sp in subs.choices.items():
        out[name] = {
            (a.option_strings[-1] if a.option_strings else a.dest):
                (a.dest, a.default, a.const, a.nargs,
                 tuple(a.choices) if a.choices else None, a.type,
                 type(a).__name__)
            for a in sp._actions if a.dest != "help"}
    return out


def test_parser_flags_match_the_jax_parser():
    ours, ref = _flags(tcli.build_parser()), _flags(jcli.build_parser())
    assert set(ours) == {"transcribe", "vad", "serve"}
    for sub in ours:
        want = {k: v for k, v in ref[sub].items()
                if k not in ("--mic", "--device", "--seconds")}
        got = dict(ours[sub])
        assert got.pop("--torch-device") == ("torch_device", "cuda", None, None,
                                             None, None, "_StoreAction")
        assert got == want, sub


def test_serve_boots_and_stops(capsys, monkeypatch):
    """The serve subcommand on the CPU: the engine loads, the front listens,
    and it shuts down on KeyboardInterrupt."""
    def interrupt(_):
        raise KeyboardInterrupt

    monkeypatch.setattr(tcli.time, "sleep", interrupt)
    out = _stdout(tcli.main, ["serve", "--model", NPZ, "--port", "0",
                              "--max-batch", "4", "--torch-device", "cpu"], capsys)
    assert out.startswith("serving on http://127.0.0.1:")
    assert out.rstrip().endswith(f"(model={NPZ}, max_batch=4)")


# -- WhisperEngine.from_env and the factory ----------------------------------

ENVS = [{"SPITTLE_QUANTIZE_DECODER": v} for v in ("0", "1", "int8", "int4", "w8a8")]
ENVS += [{"SPITTLE_QUANTIZE_ENCODER": "1", "SPITTLE_QUANTIZE_CACHE": "1",
          "SPITTLE_WIRE": "mulaw"}, {"SPITTLE_QUANTIZE_ENCODER": "true"}, {}]


def _opts(e):
    return (e.quantize_decoder, e.quantize_encoder, e.quantize_cache, e.wire)


@pytest.mark.parametrize("env", ENVS, ids=lambda e: ",".join(
    f"{k.split('_', 1)[1]}={v}" for k, v in e.items()) or "defaults")
def test_from_env_builds_the_jax_options(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ours = WhisperEngine.from_env(device="cpu")
    assert _opts(ours) == _opts(JaxEngine.from_env())
    assert ours.device.type == "cpu"
    over = dict(quantize_encoder=True, wire="auto")
    assert (_opts(WhisperEngine.from_env(device="cpu", **over))
            == _opts(JaxEngine.from_env(**over)))


@pytest.mark.parametrize("key,value", [("SPITTLE_QUANTIZE_DECODER", "int3"),
                                       ("SPITTLE_QUANTIZE_DECODER", "true"),
                                       ("SPITTLE_WIRE", "mu-law")])
def test_from_env_raises_the_jax_error(monkeypatch, key, value):
    monkeypatch.setenv(key, value)
    with pytest.raises(ValueError) as ref:
        JaxEngine.from_env()
    with pytest.raises(ValueError) as ours:
        WhisperEngine.from_env(device="cpu")
    assert str(ours.value) == str(ref.value)


def test_from_env_defaults_to_the_card():
    if torch.cuda.is_available():
        assert WhisperEngine.from_env().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            WhisperEngine.from_env()


@pytest.mark.parametrize("engine_type,cls", [
    ("whisper", WhisperEngine), ("parakeet", ParakeetEngine),
    ("moonshine", MoonshineEngine), ("sense_voice", SenseVoiceEngine)])
def test_factory_returns_the_port_engines(engine_type, cls):
    eng = factory.default_engine_factory(engine_type, device="cpu")
    assert type(eng) is cls and eng.device.type == "cpu"


def test_factory_refuses_an_unknown_type():
    with pytest.raises(ValueError, match="unknown engine_type 'wav2vec'"):
        factory.default_engine_factory("wav2vec", device="cpu")


def test_factory_reads_env_and_loads_the_draft(monkeypatch):
    monkeypatch.setenv("SPITTLE_QUANTIZE_DECODER", "int8")
    monkeypatch.setenv("SPITTLE_DRAFT_MODEL", NPZ)
    eng = factory.default_engine_factory("whisper", device="cpu")
    assert eng.quantize_decoder == "int8"
    assert eng.draft_params is None
    eng.load_model(NPZ)
    assert eng.is_loaded and eng.draft_params is not None
    assert eng.draft_cfg.n_text_layer == eng.cfg.n_text_layer


def test_jax_app_transcribes_through_the_port_factory(tmp_path):
    """AppServices(engine_factory=partial(default_engine_factory,
    device="cpu")): the TranscriptionManager loads the port's engine and
    gives the JAX factory's text on the same clip."""
    from spittle_tpu.app.services import AppServices

    clip = tcc.utterance([4, 2, 3, 0])[0][:6 * 16000]
    texts = {}
    for name, fac in (("port", functools.partial(factory.default_engine_factory,
                                                 device="cpu")),
                      ("jax", None)):
        services = AppServices(str(tmp_path / name), engine_factory=fac)
        try:
            services.transcription.load_model("trained-tiny", NPZ, "whisper")
            engine = services.transcription._engine
            assert isinstance(engine, WhisperEngine) == (name == "port")
            texts[name] = services.transcription.transcribe(clip)
        finally:
            services.shutdown()
    assert texts["port"] == texts["jax"]
    assert texts["port"].strip()
