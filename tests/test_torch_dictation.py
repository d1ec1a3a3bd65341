"""The dictation flow end to end through both packages on the CPU: a
shortcut press, audio pushed into a QueueSource in 30 ms chunks, the
release, the recorder and its manager, the transcription manager over
each package's default engine factory on the trained tiny checkpoint
(tests/data/trained_tiny/params.npz; the port on device="cpu"), the text
chain, the pipeline and the paste; then the post-process binding, whose
pipeline writes the history row. For two golden utterances the pasted
text and the history row are equal between the packages and equal to the
goldens' text, exactly."""

import json
import os
import sys
import time

import pytest
import torch

from spittle_tpu.app.actions import ActionContext as JActionContext
from spittle_tpu.app.services import AppServices as JAppServices
from spittle_tpu.audio.recorder import QueueSource as JQueueSource
from spittle_tpu.pipeline import BufferTextOutput as JBufferTextOutput
from spittle_tpu_torch.app.actions import ActionContext
from spittle_tpu_torch.app.services import AppServices
from spittle_tpu_torch.audio.recorder import QueueSource
from spittle_tpu_torch.pipeline import BufferTextOutput

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import train_committed_checkpoint as tcc  # noqa: E402
from _fresh_sources import FreshSources  # noqa: E402

DATA = os.path.join(REPO, "tests", "data", "trained_tiny")
NPZ = os.path.join(DATA, "params.npz")
CASES = (0, 3)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's eager decode loop beside the suite's other workers: one
    intra-op thread, the previous count restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def goldens():
    with open(os.path.join(DATA, "goldens.json")) as f:
        return json.load(f)


def _wait(pred, what, timeout=120.0):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.02)


def _cycle(services, actions, src, binding, audio):
    """Press, push `audio` in 30 ms chunks, release; wait until the
    pipeline thread has cleared the binding's toggle state."""
    with services.toggle_lock:
        services.toggle_state.pop(binding, None)
    actions.handle_shortcut_event(binding, "ctrl+space", True)
    assert services.audio.is_recording()
    for i in range(0, len(audio), 480):
        src.push(audio[i:i + 480])
    actions.handle_shortcut_event(binding, "ctrl+space", False)
    _wait(lambda: services.toggle_state.get(binding) is False, f"{binding}'s pipeline")


def dictate(make_services, make_source, make_output, make_context, tmp, utterances):
    """Both bindings over each utterance through one package's app. Returns
    the pasted buffers and the history rows, in the order they were saved."""
    src = FreshSources(make_source)
    services = make_services(str(tmp), src)
    try:
        services.transcription.load_model("trained-tiny", NPZ, "whisper")
        pasted, rows = [], []
        for audio in utterances:
            out = make_output()
            actions = make_context(services, out)
            services.update_settings(post_process_enabled=False)
            _cycle(services, actions, src, "transcribe", audio)
            pasted.append(out.buffer)
            services.update_settings(post_process_enabled=True)
            n = len(services.history.get_history_entries())
            _cycle(services, actions, src, "transcribe_with_post_process", audio)
            _wait(lambda: len(services.history.get_history_entries()) > n,
                  "the history row")
            # Newest by id: rows saved within one second tie on timestamp,
            # the history's sort key.
            e = max(services.history.get_history_entries(), key=lambda r: r.id)
            rows.append((e.title, e.transcription_text, e.post_processed_text,
                         e.post_process_prompt))
            pasted.append(out.buffer)
        return pasted, rows
    finally:
        services.shutdown()


def test_dictation_flow_pastes_the_golden_text(tmp_path, goldens):
    utterances = [tcc.utterance(goldens["cases"][c]["word_ids"])[0] for c in CASES]
    texts = [goldens["cases"][c]["greedy_text"] for c in CASES]
    got = dictate(lambda d, sf: AppServices(d, source_factory=sf, device="cpu"),
                  QueueSource, BufferTextOutput, ActionContext,
                  tmp_path / "port", utterances)
    want = dictate(lambda d, sf: JAppServices(d, source_factory=sf),
                   JQueueSource, JBufferTextOutput, JActionContext,
                   tmp_path / "jax", utterances)
    assert got == want
    pasted, rows = got
    # "transcribe" pastes the text and a space (BufferTextOutput.paste);
    # the post-process binding, with no LLM model set, pastes the raw text
    # after it and saves it, unprocessed, as the history row.
    for i, text in enumerate(texts):
        assert pasted[2 * i] == text + " "
        assert pasted[2 * i + 1] == text + " " + text
    assert rows == [(t[:64], t, None, None) for t in texts]
