"""The port's app managers against the JAX package on the CPU: the event
bus, the history store (sqlite rows, WAV files, retention, one package's
database read by the other), the model manager over a local catalog and
local files (nothing is downloaded), the transcription manager's text
chain and parameters over the mock engine, and the domain selector's
scoring and hysteresis. Every comparison is exact (host code)."""

import dataclasses
import os

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from spittle_tpu import events as jev
from spittle_tpu.config import catalog as jcat
from spittle_tpu.config import settings as jset
from spittle_tpu.engine import mock as jmock
from spittle_tpu.managers import domain_selector as jds
from spittle_tpu.managers import history as jhist
from spittle_tpu.managers import model as jmodel
from spittle_tpu.managers import transcription as jtr
from spittle_tpu_torch import events as tev
from spittle_tpu_torch.config import catalog as tcat
from spittle_tpu_torch.config import settings as tset
from spittle_tpu_torch.engine import mock as tmock
from spittle_tpu_torch.managers import domain_selector as tds
from spittle_tpu_torch.managers import history as thist
from spittle_tpu_torch.managers import model as tmodel
from spittle_tpu_torch.managers import transcription as ttr

PACKAGES = {
    "jax": (jev, jset, jcat, jmock, jds, jhist, jmodel, jtr),
    "port": (tev, tset, tcat, tmock, tds, thist, tmodel, ttr),
}


def test_event_names_and_bus():
    names = {k: v for k, v in vars(jev).items() if k.isupper()}
    assert names == {k: v for k, v in vars(tev).items() if k.isupper()}
    logs = {}
    for name, (ev, *_rest) in PACKAGES.items():
        bus, seen = ev.EventBus(), []
        off = bus.listen(ev.MIC_LEVEL, lambda p: seen.append(("mic", p)))
        bus.listen_all(lambda e, p: seen.append((e, p)))
        bus.listen(ev.HIDE_OVERLAY, lambda p: 1 / 0)  # never breaks the emitter
        bus.emit(ev.MIC_LEVEL, [0.5])
        off()
        bus.emit(ev.MIC_LEVEL, [0.25])
        bus.emit(ev.HIDE_OVERLAY)
        logs[name] = (seen, bus.recent(), bus.recent(ev.MIC_LEVEL))
    assert logs["port"] == logs["jax"]


def _history(name, data_dir, retention="preserve_limit", limit=3):
    ev, st_, *_rest, hist, _m, _t = PACKAGES[name]
    return hist.HistoryManager(
        str(data_dir), retention_getter=lambda: st_.RecordingRetentionPeriod(retention),
        history_limit_getter=lambda: limit)


def _rows(mgr):
    return [(e.id, e.timestamp, e.saved, e.title, e.transcription_text,
             e.post_processed_text, e.post_process_prompt, bool(e.file_name))
            for e in mgr.get_history_entries()]


@pytest.mark.parametrize("retention", ["preserve_limit", "never", "days3"])
def test_history_rows_wavs_and_retention(tmp_path, retention):
    rng = np.random.default_rng(7)
    now = 1_700_000_000
    takes = [(rng.standard_normal(800).astype(np.float32) * 0.3, f"t{i}",
              f"raw {i}", None if i % 2 else f"post {i}", None if i % 3 else "p",
              now - i * 86_400) for i in range(6)]
    got = {}
    for name in PACKAGES:
        mgr = _history(name, tmp_path / name, retention)
        ids = []
        for samples, title, raw, post, prompt, ts in takes[:3]:
            ids.append(mgr.save_transcription(samples, title, raw, post, prompt, ts))
        mgr.toggle_saved_status(ids[0])
        for samples, title, raw, post, prompt, ts in takes[3:]:
            mgr.save_transcription(samples, title, raw, post, prompt, ts)
        mgr.save_transcription(None, "no audio", "text only")
        entries = mgr.get_history_entries()
        wavs = [open(mgr.recording_path(e), "rb").read() for e in entries
                if e.file_name and mgr.recording_path(e)]
        # The row without audio takes the clock's timestamp: left out.
        got[name] = ([r for r in _rows(mgr) if r[3] != "no audio"], wavs)
    assert got["port"] == got["jax"]


def test_history_database_crosses_packages(tmp_path):
    """A history.db (and its recordings) written by the JAX package reads
    back through the port's manager with the same rows, and the port adds
    to it."""
    jmgr = _history("jax", tmp_path, limit=10)
    jmgr.save_transcription(np.ones(160, np.float32) * 0.1, "a", "alpha", "Alpha.", "p", 1)
    jmgr.save_transcription(None, "b", "beta", None, None, 2)
    tmgr = _history("port", tmp_path, limit=10)
    assert _rows(tmgr) == _rows(jmgr)
    tmgr.save_transcription(np.zeros(160, np.float32), "c", "gamma", None, None, 3)
    assert _rows(jmgr) == _rows(tmgr) and len(_rows(tmgr)) == 3


def _catalog(cat):
    full = cat.load_model_catalog()
    return dataclasses.replace(full, models=full.models[:4])


def test_model_manager_on_local_files(tmp_path):
    """A local catalog of four entries; one entry's file and one custom
    .bin on disk; discovery, paths, auto-selection and deletion."""
    got = {}
    for name, (ev, _s, cat, *_rest) in PACKAGES.items():
        models_dir = tmp_path / name
        models_dir.mkdir()
        catalog = _catalog(cat)
        first = catalog.models[1]
        (models_dir / first.filename).write_bytes(b"\0" * 64)
        (models_dir / "my-own.bin").write_bytes(b"\0" * 32)
        (models_dir / "half.bin.partial").write_bytes(b"\0")
        selected = []
        mgr = PACKAGES[name][6].ModelManager(
            str(models_dir), catalog=catalog, events=ev.EventBus(),
            selected_model_getter=lambda: "", selected_model_setter=selected.append)
        infos = [dataclasses.asdict(m) for m in mgr.get_available_models()]
        for m in infos:
            m["path"] = os.path.relpath(m["path"], models_dir)
        state = [(e.id, mgr.is_downloaded(e.id), mgr.get_model_path(e.id) is not None)
                 for e in catalog.models] + [("my-own.bin", mgr.is_downloaded("my-own.bin"))]
        mgr.delete_model(first.id)
        got[name] = (infos, state, selected, mgr.is_downloaded(first.id),
                     sorted(os.listdir(models_dir)))
    assert got["port"] == got["jax"]
    assert got["port"][2][0] == _catalog(tcat).models[1].id


TEXTS = ["um so we deploy the kubernetes cluster with helm", "", "uh",
         "Thank you.", "the react component uses type script and next js",
         "I I I I think the pandas data frame is fine"]


@pytest.mark.parametrize("changes", [
    {},
    {"custom_words": ["Kubernetes", "TypeScript"], "word_correction_threshold": 0.3},
    {"jargon_enabled_profiles": ["web_dev", "devops"],
     "jargon_custom_terms": ["Spittle"],
     "jargon_custom_corrections": [{"from": "next js", "to": "Next.js"}],
     "selected_language": "de", "translate_to_english": True},
    {"jargon_enabled_profiles": ["data_science"], "domain_selector_enabled": True,
     "domain_selector_timeout_ms": 5000, "domain_selector_blend_manual_profiles": True},
], ids=["defaults", "custom words", "jargon", "domain selector"])
def test_transcription_manager_text_chain(changes):
    """The mock engine's canned text through each package's manager: the
    same params to the engine, the same text out, the same state events."""
    got = {}
    for name, (ev, st_, _c, mock, ds, _h, _m, tr) in PACKAGES.items():
        s = st_.AppSettings.from_dict(changes)
        bus = ev.EventBus()
        mgr = tr.TranscriptionManager(
            engine_factory=lambda et: mock.MockEngine(), settings_provider=lambda: s,
            events=bus, domain_selector=ds.DomainSelectorManager())
        try:
            mgr.load_model("mock", "/nowhere", "whisper")
            params, out = [], []
            for text in TEXTS:
                mgr._engine.canned_text = text
                params.append(dataclasses.asdict(mgr._build_params(s)))
                out.append(mgr.transcribe(np.zeros(1600, np.float32)))
            mgr.unload_model()
            got[name] = (params, out, mgr._engine, bus.recent())
        finally:
            mgr.shutdown()
    assert got["port"] == got["jax"]


WORD = st.sampled_from(["react", "kubernetes", "pandas", "terraform", "the", "gpio",
                        "firmware", "invoice", "suspect", "docker", "numpy", "a"])


@settings(max_examples=40, deadline=None)
@given(st.lists(st.lists(WORD, max_size=10).map(" ".join), min_size=1, max_size=4))
def test_domain_selector_scores_and_hysteresis(texts):
    s = {name: PACKAGES[name][1].AppSettings.from_dict(
        {"domain_selector_enabled": True, "domain_selector_timeout_ms": 5000,
         "domain_selector_top_k": 2, "domain_selector_hysteresis": 0.1})
         for name in PACKAGES}
    sel = {name: PACKAGES[name][4].DomainSelectorManager() for name in PACKAGES}
    for text in texts:
        ranked = {}
        for name, (_e, _s, _c, _m, ds, *_rest) in PACKAGES.items():
            profiles = ds.build_profile_map(s[name])
            prompts = s[name].post_process_prompts
            ranked[name] = (
                [dataclasses.astuple(r) for r in ds.score_profiles(profiles, text)],
                [dataclasses.astuple(r) for r in ds.score_prompts(prompts, text)],
                sel[name].select_profiles_with_timeout(s[name], ds.DomainContext(text)))
        assert ranked["port"] == ranked["jax"]
