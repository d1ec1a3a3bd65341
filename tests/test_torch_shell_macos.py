"""The port's macOS shell (spittle_tpu_torch/shell/{macos_cocoa,macos_ax,
macos_keys,macos_mic,macos_overlay,macos_tray}.py) against the JAX
package's on Linux, at exact equality.

Every scenario of tests/test_macos_shell.py and tests/test_macos_ax.py runs
once per package over the same fake, and the two records must be equal:

- a C fake of libobjc, CoreGraphics/CoreFoundation and AudioToolbox
  (compiled once for this module with `cc`; the JAX tests' fake plus a
  reset, a run loop that cannot miss its stop, and AudioQueueStop/Dispose
  counts) drives the real ctypes marshalling: the objc selector and
  argument log (in C and at ObjCRuntime.send), a menu action through the
  registered IMP, the CGEventTap mask and the chord events fired from C,
  and the PCM at MacMicSource.read after the AudioQueue callback;
- a Python fake AX backend drives the replace-range arithmetic and
  SystemTextOutput.apply_text_diff's AX path.

`compile_fake`, `runtime` and `fake_macos` are shared with the tests of
the darwin arms of build_app, the overlay selection and the mic factory.
"""

import ctypes
import importlib
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

PKGS = ("spittle_tpu", "spittle_tpu_torch")

FAKE_C = r"""
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>

/* ---------------- objc runtime fake ---------------- */

#define MAX_LOG 4096
static char log_sel[MAX_LOG][64];
static long long log_arg1[MAX_LOG];
static int log_n = 0;

static char classes[256][64];
static int n_classes = 0;
static char sels[1024][64];
static int n_sels = 0;

static long long tags[4096];      /* receiver handle -> tag (setTag:) */
static long long next_obj = 1000;

/* menuAction: IMP registered via class_addMethod */
static void *registered_imp = 0;

void *objc_getClass(const char *name) {
    for (int i = 0; i < n_classes; i++)
        if (!strcmp(classes[i], name)) return (void *)(long long)(i + 1);
    strncpy(classes[n_classes], name, 63);
    n_classes++;
    return (void *)(long long)n_classes;
}

void *sel_registerName(const char *name) {
    for (int i = 0; i < n_sels; i++)
        if (!strcmp(sels[i], name)) return (void *)(long long)(i + 1 + 500);
    strncpy(sels[n_sels], name, 63);
    n_sels++;
    return (void *)(long long)(n_sels + 500);
}

static const char *sel_name(void *sel) {
    long long i = (long long)sel - 501;
    return (i >= 0 && i < n_sels) ? sels[i] : "?";
}

void *objc_msgSend(void *self, void *sel, void *p1, void *p2, void *p3,
                   void *p4) {
    const char *name = sel_name(sel);
    (void)p2; (void)p3; (void)p4;
    if (log_n < MAX_LOG) {
        strncpy(log_sel[log_n], name, 63);
        log_arg1[log_n] = (long long)p1;
        log_n++;
    }
    if (!strcmp(name, "setTag:")) {
        tags[((long long)self) % 4096] = (long long)p1;
        return 0;
    }
    if (!strcmp(name, "tag"))
        return (void *)tags[((long long)self) % 4096];
    return (void *)(++next_obj);
}

void *objc_allocateClassPair(void *super, const char *name, size_t extra) {
    (void)super; (void)extra;
    return objc_getClass(name);
}

int class_addMethod(void *cls, void *sel, void *imp, const char *types) {
    (void)cls; (void)types;
    if (!strcmp(sel_name(sel), "menuAction:")) registered_imp = imp;
    return 1;
}

void objc_registerClassPair(void *cls) { (void)cls; }

int fake_log_count(void) { return log_n; }
const char *fake_log_sel(int i) { return log_sel[i]; }
long long fake_log_arg1(int i) { return log_arg1[i]; }
void fake_log_reset(void) { log_n = 0; }

/* fire the registered menuAction: IMP with a sender that has a tag */
void fake_click_menu_item(long long tag) {
    long long sender = 3999;
    tags[sender % 4096] = tag;
    if (registered_imp)
        ((void (*)(void *, void *, void *))registered_imp)(
            0, 0, (void *)sender);
}

/* ---------------- CGEventTap / CFRunLoop fake ---------------- */

typedef void *(*tap_cb)(void *, uint32_t, void *, void *);
static tap_cb tap_callback = 0;
static uint64_t tap_mask = 0;
static uint32_t tap_options = 99;
static int64_t ev_keycode = 0;
static uint64_t ev_flags = 0;
static int tap_enabled = 0;
/* Each CFRunLoopRun returns once as many stops as runs before it have
   been asked for, so a stop that comes first is not lost. */
static volatile int rl_runs = 0, rl_stops = 0;

void *CGEventTapCreate(uint32_t tap, uint32_t place, uint32_t options,
                       uint64_t mask, tap_cb cb, void *refcon) {
    (void)tap; (void)place; (void)refcon;
    tap_options = options;
    tap_mask = mask;
    tap_callback = cb;
    return (void *)0x7;
}

int64_t CGEventGetIntegerValueField(void *event, uint32_t field) {
    (void)event; (void)field;
    return ev_keycode;
}

uint64_t CGEventGetFlags(void *event) { (void)event; return ev_flags; }

void CGEventTapEnable(void *tap, int enable) {
    (void)tap; tap_enabled = enable;
}

void *CFMachPortCreateRunLoopSource(void *alloc, void *port, long order) {
    (void)alloc; (void)port; (void)order;
    return (void *)0x5;
}

void *CFRunLoopGetCurrent(void) { return (void *)0x6; }
void CFRunLoopAddSource(void *rl, void *src, void *mode) {
    (void)rl; (void)src; (void)mode;
}

void CFRunLoopRun(void) {
    int me = __sync_fetch_and_add(&rl_runs, 1);
    while (rl_stops <= me) usleep(1000);
}

void CFRunLoopStop(void *rl) { (void)rl; __sync_fetch_and_add(&rl_stops, 1); }

uint64_t fake_tap_mask(void) { return tap_mask; }
uint32_t fake_tap_options(void) { return tap_options; }
int fake_tap_enabled(void) { return tap_enabled; }
int fake_runloops_running(void) { return rl_runs - rl_stops; }

void fake_fire_event(uint32_t etype, int64_t keycode, uint64_t flags) {
    ev_keycode = keycode;
    ev_flags = flags;
    if (tap_callback) tap_callback((void *)0x1, etype, (void *)0x2, 0);
}

/* ---------------- AudioQueue fake ---------------- */

typedef struct AQBuffer {
    uint32_t mAudioDataBytesCapacity;
    void *mAudioData;
    uint32_t mAudioDataByteSize;
    void *mUserData;
    uint32_t mPacketDescriptionCapacity;
    void *mPacketDescriptions;
    uint32_t mPacketDescriptionCount;
} AQBuffer;

typedef void (*aq_cb)(void *, void *, AQBuffer *, void *, uint32_t, void *);
static aq_cb aq_callback = 0;
static AQBuffer *aq_bufs[8];
static int aq_n_bufs = 0;
static int aq_enqueued = 0;
static int aq_started = 0;
static int aq_stops = 0, aq_disposes = 0;
static double aq_rate = 0;
static uint32_t aq_format = 0, aq_channels = 0, aq_bits = 0;

typedef struct {
    double mSampleRate;
    uint32_t mFormatID, mFormatFlags, mBytesPerPacket, mFramesPerPacket,
        mBytesPerFrame, mChannelsPerFrame, mBitsPerChannel, mReserved;
} ASBD;

int32_t AudioQueueNewInput(ASBD *fmt, aq_cb cb, void *user, void *rl,
                           void *mode, uint32_t flags, void **out) {
    (void)user; (void)rl; (void)mode; (void)flags;
    aq_n_bufs = 0;  /* a new queue: the buffers of an earlier one go */
    aq_rate = fmt->mSampleRate;
    aq_format = fmt->mFormatID;
    aq_channels = fmt->mChannelsPerFrame;
    aq_bits = fmt->mBitsPerChannel;
    aq_callback = cb;
    *out = (void *)0xAA;
    return 0;
}

int32_t AudioQueueAllocateBuffer(void *q, uint32_t nbytes, AQBuffer **out) {
    (void)q;
    if (aq_n_bufs >= 8) return -1;
    AQBuffer *b = (AQBuffer *)calloc(1, sizeof(AQBuffer));
    b->mAudioDataBytesCapacity = nbytes;
    b->mAudioData = malloc(nbytes);
    aq_bufs[aq_n_bufs++] = b;
    *out = b;
    return 0;
}

int32_t AudioQueueEnqueueBuffer(void *q, AQBuffer *b, uint32_t n, void *d) {
    (void)q; (void)b; (void)n; (void)d;
    aq_enqueued++;
    return 0;
}

int32_t AudioQueueStart(void *q, void *ts) {
    (void)q; (void)ts; aq_started = 1; return 0;
}
int32_t AudioQueueStop(void *q, int now) {
    (void)q; (void)now; aq_started = 0; aq_stops++; return 0;
}
int32_t AudioQueueDispose(void *q, int now) {
    (void)q; (void)now; aq_disposes++; return 0;
}

double fake_aq_rate(void) { return aq_rate; }
uint32_t fake_aq_format(void) { return aq_format; }
uint32_t fake_aq_channels(void) { return aq_channels; }
uint32_t fake_aq_bits(void) { return aq_bits; }
int fake_aq_enqueued(void) { return aq_enqueued; }
int fake_aq_started(void) { return aq_started; }
int fake_aq_stops(void) { return aq_stops; }
int fake_aq_disposes(void) { return aq_disposes; }

void fake_aq_feed(const float *samples, int n) {
    if (!aq_callback || aq_n_bufs == 0) return;
    AQBuffer *b = aq_bufs[0];
    uint32_t nbytes = (uint32_t)(n * 4);
    if (nbytes > b->mAudioDataBytesCapacity)
        nbytes = b->mAudioDataBytesCapacity;
    memcpy(b->mAudioData, samples, nbytes);
    b->mAudioDataByteSize = nbytes;
    aq_callback(0, (void *)0xAA, b, 0, (uint32_t)n, 0);
}

/* Everything a scenario reads back, to the state of a fresh process (the
   selector and class tables keep their ids). */
void fake_reset(void) {
    log_n = 0;
    next_obj = 1000;
    memset(tags, 0, sizeof(tags));
    tap_callback = 0; tap_mask = 0; tap_options = 99; tap_enabled = 0;
    ev_keycode = 0; ev_flags = 0;
    aq_callback = 0; aq_n_bufs = 0; aq_enqueued = 0; aq_started = 0;
    aq_stops = 0; aq_disposes = 0;
    aq_rate = 0; aq_format = aq_channels = aq_bits = 0;
}
"""

# Selectors whose first argument does not reach objc_msgSend's third
# integer register (none, a double, or a struct), or is a buffer address:
# their arg1 in the C log is not compared.
_ARG1_UNSEEN = {"colorWithSRGBRed:green:blue:alpha:", "statusItemWithLength:",
                "setFrameOrigin:", "initWithFrame:", "setFrame:",
                "stringWithUTF8String:"}


def compile_fake(directory) -> ctypes.CDLL:
    """The fake built with `cc` into `directory` and loaded."""
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        pytest.skip("no C compiler in image")
    src = directory / "fake_macos.c"
    src.write_text(FAKE_C)
    out = directory / "libfake_macos.so"
    subprocess.run([cc, "-shared", "-fPIC", "-O1", "-o", str(out), str(src)],
                   check=True)
    lib = ctypes.CDLL(str(out))
    lib.fake_log_sel.restype = ctypes.c_char_p
    lib.fake_log_arg1.restype = ctypes.c_longlong
    lib.fake_tap_mask.restype = ctypes.c_uint64
    lib.fake_aq_rate.restype = ctypes.c_double
    lib.fake_fire_event.argtypes = [ctypes.c_uint32, ctypes.c_int64, ctypes.c_uint64]
    lib.fake_aq_feed.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int]
    lib.fake_click_menu_item.argtypes = [ctypes.c_longlong]
    return lib


@pytest.fixture(scope="module")
def fake_lib(tmp_path_factory):
    return compile_fake(tmp_path_factory.mktemp("torch_macos_shell"))


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def both(scenario, *args, **kw):
    """The scenario's record for each package; they must be equal. Returns
    the port's."""
    got = {pkg: scenario(pkg, *args, **kw) for pkg in PKGS}
    assert got["spittle_tpu_torch"] == got["spittle_tpu"]
    return got["spittle_tpu_torch"]


def _plain(a):
    if hasattr(a, "origin"):
        return ("rect", a.origin.x, a.origin.y, a.size.width, a.size.height)
    if hasattr(a, "x") and hasattr(a, "y"):
        return ("point", a.x, a.y)
    return a


def runtime(pkg, lib):
    """The package's ObjCRuntime over the fake, the fake reset first, each
    message it sends logged in rt.calls as (receiver, selector, arguments,
    restype, argtypes)."""
    lib.fake_reset()
    rt = mod(pkg, "shell.macos_cocoa").ObjCRuntime(lib)
    rt.calls = []
    send = rt.send

    def logged(receiver, selname, *args, restype=ctypes.c_void_p, argtypes=None):
        rt.calls.append((receiver, selname, tuple(_plain(a) for a in args),
                         restype.__name__,
                         None if argtypes is None else tuple(t.__name__ for t in argtypes)))
        return send(receiver, selname, *args, restype=restype, argtypes=argtypes)

    rt.send = logged
    return rt


def c_log(lib):
    """The fake's message log: (selector, first integer argument or None)."""
    out = []
    for i in range(lib.fake_log_count()):
        sel = lib.fake_log_sel(i).decode()
        seen = ":" in sel and sel not in _ARG1_UNSEEN
        out.append((sel, lib.fake_log_arg1(i) if seen else None))
    return out


def sels(lib):
    return [s for s, _ in c_log(lib)]


def fake_macos(pkg, lib, monkeypatch, screen=(1920, 1080)):
    """Patch the package's macOS shell to build over the fake: the default
    runtime is an ObjCRuntime over it (logged, see runtime), QuartzBackend
    takes it as CoreGraphics and CoreFoundation, and MacBackend knows its
    screen. Returns the runtime."""
    rt = runtime(pkg, lib)
    cocoa = mod(pkg, "shell.macos_cocoa")
    keys = mod(pkg, "shell.macos_keys")
    overlay = mod(pkg, "shell.macos_overlay")
    quartz, backend = keys.QuartzBackend, overlay.MacBackend
    monkeypatch.setattr(cocoa, "default_runtime", lambda: rt)
    monkeypatch.setattr(keys, "QuartzBackend", type("QuartzBackend", (quartz,), {
        "__init__": lambda self: quartz.__init__(self, cg=lib, cf=lib)}))
    monkeypatch.setattr(overlay, "MacBackend", type("MacBackend", (backend,), {
        "__init__": lambda self, runtime=None, screen_=screen:
            backend.__init__(self, runtime, screen=screen_)}))
    return rt


def _wait(pred, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.005)
    return True


# ---------------- NSPanel overlay backend ----------------


def _overlay_window(pkg, lib):
    m = mod(pkg, "shell.macos_overlay")
    rt = runtime(pkg, lib)
    b = m.MacBackend(rt, screen=(1920, 1080))
    opened = b.open()
    b.create_window(874, 20, 172, 36, 0xDC2626)
    return dict(opened=opened, log=c_log(lib), calls=rt.calls,
                consts=(m.NS_NONACTIVATING_PANEL, m.NS_STATUS_WINDOW_LEVEL))


def test_overlay_create_window_message_sequence(fake_lib):
    r = both(_overlay_window, fake_lib)
    s = [sel for sel, _ in r["log"]]
    assert r["opened"]
    for sel in ("initWithContentRect:styleMask:backing:defer:", "setLevel:",
                "setIgnoresMouseEvents:", "setCollectionBehavior:"):
        assert sel in s
    assert "orderFrontRegardless" not in s
    nonactivating, level = r["consts"]
    assert r["log"][s.index("setLevel:")][1] == level
    init = r["log"][s.index("initWithContentRect:styleMask:backing:defer:")]
    assert init[1] & nonactivating


def _overlay_map(pkg, lib):
    rt = runtime(pkg, lib)
    b = mod(pkg, "shell.macos_overlay").MacBackend(rt, screen=(1920, 1080))
    b.create_window(874, 20, 172, 36, 0xDC2626)
    lib.fake_log_reset()
    del rt.calls[:]
    b.map()
    b.fill_rect(0xFFFFFF, 2, 4, 6, 10)
    b.fill_rect(0xFFFFFF, 2, 4, 6, 20)  # same slot: reframed
    b.move(100, 200)
    b.unmap()
    return dict(log=c_log(lib), calls=rt.calls, bars=len(b._bars))


def test_overlay_map_unmap_and_bars(fake_lib):
    r = both(_overlay_map, fake_lib)
    s = [sel for sel, _ in r["log"]]
    assert s[0] == "orderFrontRegardless"
    assert s.count("initWithFrame:") == 1 and "setFrame:" in s
    assert "orderOut:" in s and r["bars"] == 1
    # y flipped to bottom-up: the second bar's frame and the moved origin.
    frames = [c[2][0] for c in r["calls"] if c[1] == "setFrame:"]
    assert frames == [("rect", 2.0, 36.0 - 4 - 20, 6.0, 20.0)]
    assert [c[2][0] for c in r["calls"] if c[1] == "setFrameOrigin:"] == [
        ("point", 100.0, 1080.0 - 200 - 36)]


def _overlay_background(pkg, lib):
    rt = runtime(pkg, lib)
    b = mod(pkg, "shell.macos_overlay").MacBackend(rt, screen=(1920, 1080))
    b.create_window(874, 20, 172, 36, 0xDC2626)
    b.fill_rect(0xFFFFFF, 2, 4, 6, 10)
    lib.fake_log_reset()
    b.set_background(0x2563EB)
    log = c_log(lib)
    b.close()
    return dict(log=log, bars=len(b._bars), closed=sels(lib)[-1], panel=b.panel)


def test_overlay_set_background_drops_bars(fake_lib):
    r = both(_overlay_background, fake_lib)
    assert "removeFromSuperview" in [s for s, _ in r["log"]]
    assert r["bars"] == 0 and r["closed"] == "close" and r["panel"] is None


def _overlay_controller(pkg, lib, data_dir):
    services = mod(pkg, "app.services").AppServices(
        str(data_dir / pkg), use_mock_engine=True,
        **({"device": "cpu"} if pkg == "spittle_tpu_torch" else {}))
    events = mod(pkg, "events")
    try:
        services.update_settings(
            overlay_position=mod(pkg, "config.settings").OverlayPosition("bottom"))
        rt = runtime(pkg, lib)
        backend = mod(pkg, "shell.macos_overlay").MacBackend(rt, screen=(1280, 800))
        ov = mod(pkg, "shell.x11_overlay").X11Overlay(
            services.events, services.get_settings, backend=backend)
        active = ov.active
        services.events.emit(events.SHOW_OVERLAY, "recording")
        services.events.emit(events.HIDE_OVERLAY, None)
        assert _wait(lambda: "orderOut:" in sels(lib))
        ov.close()
        ov._thread.join(timeout=5)
        return dict(active=active, log=c_log(lib), calls=rt.calls)
    finally:
        services.shutdown()


def test_overlay_controller_drives_backend(fake_lib, tmp_path):
    """The shared X11Overlay controller over the mac backend: a show
    event configures and orders the panel front, a hide orders it out."""
    r = both(_overlay_controller, fake_lib, tmp_path)
    s = [sel for sel, _ in r["log"]]
    assert r["active"] and "orderFrontRegardless" in s and "orderOut:" in s
    assert s.index("orderFrontRegardless") < s.index("orderOut:")


# ---------------- NSStatusItem tray ----------------

MENU = [("settings", "Settings"), ("cancel", "Cancel"), ("quit", "Quit")]


def _tray(pkg, lib, clicks=(), state=None):
    rt = runtime(pkg, lib)
    clicked = []
    tray = mod(pkg, "shell.macos_tray").MacTray(MENU, on_menu=clicked.append,
                                                 runtime=rt)
    built = c_log(lib)
    for tag in clicks:
        lib.fake_click_menu_item(tag)
    lib.fake_log_reset()
    if state is not None:
        tray.set_state(mod(pkg, "app.ui_state").TrayIconState(state))
    tray.close()
    return dict(built=built, after=c_log(lib), clicked=clicked, calls=rt.calls,
                state=tray.state.value)


def test_tray_builds_status_item_with_menu(fake_lib):
    r = both(_tray, fake_lib)
    s = [sel for sel, _ in r["built"]]
    assert "statusItemWithLength:" in s and "setMenu:" in s
    assert s.count("initWithTitle:action:keyEquivalent:") == 3
    assert s.count("setTarget:") == 3
    assert [a for sel, a in r["built"] if sel == "setTag:"] == [0, 1, 2]
    titles = [c[2][0] for c in r["calls"] if c[1] == "stringWithUTF8String:"]
    assert titles == ["\U0001f399".encode(), b"Settings", b"", b"Cancel", b"",
                      b"Quit", b""]


def test_tray_menu_action_dispatches_through_real_imp(fake_lib):
    """C calls the registered IMP (a ctypes thunk) with a tagged sender;
    the tray resolves the tag to the item id."""
    r = both(_tray, fake_lib, clicks=(1, 2, 7))
    assert r["clicked"] == ["cancel", "quit"]


def test_tray_set_state_updates_title(fake_lib):
    r = both(_tray, fake_lib, state="recording")
    s = [sel for sel, _ in r["after"]]
    assert "setTitle:" in s and s[-1] == "removeStatusItem:"
    assert r["state"] == "recording"
    assert [c[2][0] for c in r["calls"] if c[1] == "stringWithUTF8String:"][-1] == \
        "\U0001f534".encode()


# ---------------- CGEventTap hotkeys ----------------


def _quartz(pkg, lib, drive, register=("ctrl+space",)):
    lib.fake_reset()
    keys = mod(pkg, "shell.macos_keys")
    b = keys.QuartzBackend(cg=lib, cf=lib)
    fired = []
    try:
        ok = [b.register(hk, lambda hk, p: fired.append((hk, p))) for hk in register]
        tap = (lib.fake_tap_mask(), lib.fake_tap_options(), lib.fake_tap_enabled())
        drive(keys, lib, b, fired)
    finally:
        b.close()
    return dict(ok=ok, tap=tap, fired=fired,
                consts=(keys.EVENT_MASK, keys.LISTEN_ONLY))


def test_quartz_tap_created_listen_only_with_mask(fake_lib):
    r = both(_quartz, fake_lib, lambda *a: None)
    assert r["ok"] == [True]
    assert r["tap"] == (r["consts"][0], r["consts"][1], 1)


def _chord(keys, lib, b, fired):
    lib.fake_fire_event(keys.FLAGS_CHANGED, 59, 1 << 18)  # ctrl down
    lib.fake_fire_event(keys.KEY_DOWN, 49, 1 << 18)
    lib.fake_fire_event(keys.KEY_UP, 49, 1 << 18)
    lib.fake_fire_event(keys.FLAGS_CHANGED, 59, 0)


def test_quartz_chord_press_release(fake_lib):
    r = both(_quartz, fake_lib, _chord)
    assert r["fired"] == [("ctrl+space", True), ("ctrl+space", False)]


def _specific(keys, lib, b, fired):
    lib.fake_fire_event(keys.FLAGS_CHANGED, 59, 1 << 18)
    lib.fake_fire_event(keys.FLAGS_CHANGED, 56, (1 << 18) | (1 << 17))
    lib.fake_fire_event(keys.KEY_DOWN, 49, (1 << 18) | (1 << 17))


def test_quartz_most_specific_chord_wins(fake_lib):
    r = both(_quartz, fake_lib, _specific,
             register=("ctrl+space", "ctrl+shift+space"))
    assert r["fired"] == [("ctrl+shift+space", True)]


def _capture(keys, lib, b, fired):
    b.start_capture(lambda k, p, mods: fired.append((k, p, sorted(mods))))
    lib.fake_fire_event(keys.FLAGS_CHANGED, 55, 1 << 20)  # cmd down
    lib.fake_fire_event(keys.KEY_DOWN, 0, 1 << 20)        # 'a'
    lib.fake_fire_event(keys.KEY_UP, 0, 1 << 20)
    lib.fake_fire_event(keys.KEY_DOWN, 52, 0)              # unmapped


def test_quartz_capture_mode_streams_keys(fake_lib):
    r = both(_quartz, fake_lib, _capture, register=())
    assert ("super", True, ["super"]) in r["fired"]
    assert ("a", True, ["a", "super"]) in r["fired"]


def _runloop(pkg, lib):
    lib.fake_reset()
    b = mod(pkg, "shell.macos_keys").QuartzBackend(cg=lib, cf=lib)
    ok = b.register("ctrl+space", lambda hk, p: None)
    running = _wait(lambda: lib.fake_runloops_running() == 1)
    thread = b.listener._thread
    b.close()  # CFRunLoopStop, then the join
    return dict(ok=ok, running=running, joined=not thread.is_alive(),
                left=lib.fake_runloops_running(), started=b._started)


def test_quartz_runloop_stops_on_close(fake_lib):
    r = both(_runloop, fake_lib)
    assert r == dict(ok=True, running=True, joined=True, left=0, started=False)


# ---------------- AudioQueue mic ----------------


def _aq_lifecycle(pkg, lib):
    lib.fake_reset()
    m = mod(pkg, "shell.macos_mic")
    src = m.MacMicSource(lib=lib)
    fmt = (lib.fake_aq_rate(), lib.fake_aq_format(), lib.fake_aq_channels(),
           lib.fake_aq_bits(), lib.fake_aq_started(), lib.fake_aq_enqueued())
    src.close()
    return dict(fmt=fmt, lpcm=m.FORMAT_LPCM, tool=src.tool_name,
                rate=src.sample_rate, after=(lib.fake_aq_started(),
                                             lib.fake_aq_stops(),
                                             lib.fake_aq_disposes()),
                read=src.read(0.01))


def test_mic_format_and_lifecycle(fake_lib):
    r = both(_aq_lifecycle, fake_lib)
    assert r["fmt"] == (16000.0, r["lpcm"], 1, 32, 1, 3)
    assert (r["tool"], r["rate"]) == ("audioqueue", 16000)
    assert r["after"] == (0, 1, 1) and r["read"] is None


def _aq_pcm(pkg, lib):
    lib.fake_reset()
    src = mod(pkg, "shell.macos_mic").MacMicSource(lib=lib)
    before = lib.fake_aq_enqueued()
    reads = []
    for seed, n in ((0, 256), (1, 1024), (2, 1500)):
        pcm = (np.random.default_rng(seed).uniform(-0.9, 0.9, n)).astype(np.float32)
        lib.fake_aq_feed(pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(pcm))
        got = src.read(timeout=1.0)
        reads.append((pcm.tobytes(), None if got is None else got.tobytes()))
    enq = lib.fake_aq_enqueued() - before
    src.close()
    return dict(reads=reads, reenqueued=enq)


def test_mic_pcm_flows_from_hal_callback_to_read(fake_lib):
    r = both(_aq_pcm, fake_lib)
    (a_in, a_out), (b_in, b_out), (c_in, c_out) = r["reads"]
    assert a_out == a_in and b_out == b_in
    assert c_out == c_in[:4096]  # one buffer holds 4096 bytes
    assert r["reenqueued"] == 3


# ---------------- AX selection-replace ----------------


class FakeAX:
    def __init__(self, location=20, length=0, settable=True, fail=None,
                 ax_error=None):
        self.location, self.length = location, length
        self.settable, self.fail, self.ax_error = settable, fail, ax_error
        self.set_calls = []

    def range_settable(self):
        if self.fail == "settable":
            raise RuntimeError("ax down")
        return self.settable

    def selected_range(self):
        if self.fail == "read":
            raise self.ax_error("no element")
        return self.location, self.length

    def set_selected_range(self, location, length):
        if self.fail == "set":
            raise self.ax_error("set failed")
        self.set_calls.append((location, length))


def _ax(pkg, *args, **kw):
    m = mod(pkg, "shell.macos_ax")
    be = FakeAX(*args, ax_error=m.AXError, **kw)
    return be, m


def _ranges(pkg):
    m = mod(pkg, "shell.macos_ax")
    out = [m.compute_replace_range(20, 5, 3), m.compute_replace_range(8, 8, 0)]
    try:
        m.compute_replace_range(4, 5, 3)
    except m.AXError as e:
        out.append(("AXError", str(e)))
    return out


def test_ax_compute_replace_range():
    r = both(_ranges)
    assert r[:2] == [(12, 5), (0, 8)]  # macos_ax.rs:144-157


def test_ax_compute_replace_range_underflow():
    r = both(_ranges)
    assert r[2][0] == "AXError" and "before required replace boundary" in r[2][1]


def _select(pkg, delete, suffix, **kw):
    be, m = _ax(pkg, **kw)
    return m.try_select_replace_range_before_cursor(delete, suffix, backend=be), \
        be.set_calls


def test_ax_selection_applied():
    assert both(_select, 5, 3, location=20) == (True, [(12, 5)])


@pytest.mark.parametrize("fail", ["settable", "read", "set"])
def test_ax_failures_fall_back(fail):
    assert both(_select, 2, 1, fail=fail) == (False, [])


def test_ax_not_settable_falls_back():
    assert both(_select, 2, 1, settable=False) == (False, [])


def test_ax_no_backend_off_macos():
    """The default backend resolves to None off darwin: keyboard path."""
    r = both(lambda pkg: mod(pkg, "shell.macos_ax")
             .try_select_replace_range_before_cursor(2, 1))
    if sys.platform != "darwin":
        assert r is False


def _apply_diff(pkg, suffix, delete, insert, paste_method=None, **kw):
    settings = mod(pkg, "config.settings")
    s = settings.AppSettings()
    if paste_method is not None:
        s.paste_method = settings.PasteMethod(paste_method)
    commands = []

    def runner(cmd, stdin=None):
        commands.append((tuple(cmd), stdin))
        return True

    be, _ = _ax(pkg, **kw)
    out = mod(pkg, "shell.textout").SystemTextOutput(
        settings_provider=lambda: s, runner=runner,
        which=lambda name: "/usr/bin/" + name if name == "xdotool" else None,
        ax_backend=be, uinput_factory=lambda: None)
    out.apply_text_diff(suffix_chars=suffix, delete_chars=delete, insert=insert)
    return commands, be.set_calls


def _joined(commands):
    return [" ".join(c) for c, _ in commands]


def test_apply_diff_uses_ax_path():
    """With a working AX backend: no arrows or backspaces before the type,
    Right x suffix after (clipboard.rs step 4 runs on both paths)."""
    commands, set_calls = both(_apply_diff, 2, 4, "new", location=30)
    joined = _joined(commands)
    assert set_calls == [(24, 4)]
    assert not any("Left" in j or "BackSpace" in j for j in joined)
    assert sum("Right" in j for j in joined) == 2
    assert any("type" in j and "new" in j for j in joined)


def test_apply_diff_keyboard_fallback():
    commands, _ = both(_apply_diff, 2, 3, "x", settable=False)
    joined = _joined(commands)
    assert sum("Left" in j for j in joined) == 2
    assert sum("BackSpace" in j for j in joined) == 3
    assert sum("Right" in j for j in joined) == 2


def test_apply_diff_ax_empty_insert_clears_selection():
    commands, _ = both(_apply_diff, 0, 4, "", location=30)
    assert sum("BackSpace" in j for j in _joined(commands)) == 1


def test_apply_diff_paste_method_none_skips():
    assert both(_apply_diff, 2, 4, "new", paste_method="none", location=30) == ([], [])
