"""The port's tooling against the JAX package's: Tracer.device_trace
(torch.profiler in place of jax.profiler; on the CPU its trace names the
ops run inside it) and LogSystem / init_logging (the rotating file target
at FILE_MAX_BYTES with FILE_BACKUPS, the SPITTLE_LOG console level and the
run-time file level filter, on the same records as the JAX one)."""

import json
import logging
import os

import pytest
import torch

from spittle_tpu.config.settings import LogLevel as JLevel
from spittle_tpu.utils import logging as jlog
from spittle_tpu_torch.utils import logging as tlog
from spittle_tpu_torch.utils.tracing import Tracer, get_tracer


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def restore_loggers():
    """Each test's LogSystems take over the packages' root loggers; give
    them back as they were."""
    saved = {}
    for name in ("spittle_tpu", "spittle_tpu_torch"):
        lg = logging.getLogger(name)
        saved[name] = (list(lg.handlers), lg.level, lg.propagate)
    yield
    for name, (handlers, level, propagate) in saved.items():
        lg = logging.getLogger(name)
        for h in lg.handlers:
            if h not in handlers:
                h.close()
        lg.handlers[:] = handlers
        lg.setLevel(level)
        lg.propagate = propagate


def test_device_trace_writes_a_chrome_trace(tmp_path):
    tracer = Tracer()
    a = torch.randn(64, 64)
    with tracer.device_trace(str(tmp_path / "trace")) as rec:
        b = (a @ a).relu()
    assert b.shape == (64, 64)
    path = rec["path"]
    assert path == tracer.last_trace_path
    assert os.path.dirname(path) == str(tmp_path / "trace")
    with open(path) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names and "aten::relu" in names
    # Nothing outside the region is in it.
    assert "aten::randn" not in names


def test_device_trace_default_follows_the_card(tmp_path):
    with get_tracer().device_trace(str(tmp_path)) as rec:
        torch.ones(3).sum()
    with open(rec["path"]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert bool(kernels) == torch.cuda.is_available()


def _records(log):
    log.log(5, "trace %d", 1)
    log.debug("debug %d", 2)
    log.info("info %d", 3)
    log.warning("warn %d", 4)
    log.error("error %d", 5)


def _lines(path):
    """(level, message) of each file line: the time and logger name
    differ between the packages."""
    with open(path) as f:
        out = []
        for line in f:
            parts = line.rstrip("\n").split(" ")
            out.append((parts[2], " ".join(parts[4:])))
        return out


def test_file_level_filter_matches_jax(tmp_path):
    ours = tlog.init_logging(str(tmp_path / "torch"))
    ref = jlog.init_logging(str(tmp_path / "jax"))
    assert os.path.basename(ours.log_path) == "spittle_tpu_torch.log"
    for h in ours.logger.handlers + ref.logger.handlers:
        if type(h) is logging.StreamHandler:
            h.setLevel(100)  # keep the console quiet
    for level in ["trace", "debug", "info", "warn", "error", None]:
        if level is not None:
            ours.set_file_level(tlog.LogLevel(level))
            ref.set_file_level(JLevel(level))
        _records(tlog.get_logger("x"))
        _records(jlog.get_logger("x"))
    assert _lines(ours.log_path) == _lines(ref.log_path)
    assert len(_lines(ours.log_path)) == 5 + 4 + 3 + 2 + 1 + 1


@pytest.mark.parametrize("spec", ["trace", "debug", "warning", "ERROR", "bogus", None])
def test_console_level_from_env_matches_jax(tmp_path, monkeypatch, spec):
    if spec is None:
        monkeypatch.delenv("SPITTLE_LOG", raising=False)
    else:
        monkeypatch.setenv("SPITTLE_LOG", spec)
    levels = []
    for mod in (tlog, jlog):
        system = mod.LogSystem(str(tmp_path / mod.__name__))
        console = [h for h in system.logger.handlers
                   if type(h) is logging.StreamHandler]
        assert len(console) == 1
        levels.append(console[0].level)
    assert levels[0] == levels[1]


def test_file_rotates_at_file_max_bytes(tmp_path):
    system = tlog.LogSystem(str(tmp_path))
    for h in system.logger.handlers:
        if type(h) is logging.StreamHandler:
            h.setLevel(100)
    log = tlog.get_logger("rotate")
    line = "x" * 1000
    for i in range(3 * tlog.FILE_MAX_BYTES // 1000):
        log.info("%d %s", i, line)
    files = sorted(os.listdir(tmp_path))
    assert files == ["spittle_tpu_torch.log", "spittle_tpu_torch.log.1"]
    assert tlog.FILE_BACKUPS == jlog.FILE_BACKUPS == 1
    assert tlog.FILE_MAX_BYTES == jlog.FILE_MAX_BYTES
    for name in files:
        assert os.path.getsize(tmp_path / name) <= tlog.FILE_MAX_BYTES


def test_level_table_matches_jax():
    assert [v.value for v in tlog.LogLevel] == [v.value for v in JLevel]
    assert ({k.value: v for k, v in tlog._LEVELS.items()}
            == {k.value: v for k, v in jlog._LEVELS.items()})


def test_get_logger_keeps_the_port_root():
    assert tlog.get_logger().name == "spittle_tpu_torch"
    assert tlog.get_logger("cli").name == "spittle_tpu_torch.cli"
