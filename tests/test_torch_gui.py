"""The port's GUI (``gccnmf_torch/gui_model.py``, ``gccnmf_torch/gui.py``) on
the CPU: the view-model against JAX's numerically (tests/test_gui.py's model
cases), then ``GCCNMFFigureView`` on Agg with synthetic mouse events and
``RealtimeGCCNMFWindow`` on the stub Tk of tests/fake_tk.py, driving the
port's app on the CPU through the cases of tests/test_gui.py."""

import time

import numpy as np
import pytest
import torch

import matplotlib

matplotlib.use("Agg", force=True)

import fake_tk  # noqa: E402

from gccnmf_tpu import gui_model as jgui_model  # noqa: E402
from gccnmf_torch.config import load_config  # noqa: E402
from gccnmf_torch.gui_model import (  # noqa: E402
    MaskEditorModel,
    generalized_gaussian,
    normalized_mean_gcc,
    target_window_curve,
    visualized_dictionary,
)
from gccnmf_torch.realtime.app import RealtimeGCCNMF  # noqa: E402
from gccnmf_torch.utils import wav as wavio  # noqa: E402

torch.set_num_threads(1)  # Tier-1 runs several xdist workers


def test_gui_module_imports_headless():
    import gccnmf_torch.gui as gui

    for name in ("RealtimeGCCNMFWindow", "GCCNMFFigureView", "run_gui"):
        assert hasattr(gui, name)


# ------------------------------------------------ the model against JAX's


@pytest.mark.parametrize("frac", [0.0, 0.07, 0.5, 0.91, 1.0])
def test_slider_mappings_match_jax(frac):
    n = 128
    m = MaskEditorModel(n, center_frac=frac, width_frac=frac, shape_frac=frac, floor_frac=frac)
    ref = jgui_model.MaskEditorModel(n, center_frac=frac, width_frac=frac, shape_frac=frac,
                                     floor_frac=frac)
    assert (m.tdoa, m.window_width, m.beta, m.noise_floor, m.region) == (
        ref.tdoa, ref.window_width, ref.beta, ref.noise_floor, ref.region)
    assert m.tdoa == pytest.approx(frac * n)
    assert m.beta == pytest.approx(np.exp(frac * 10.0 - 5.0))
    assert m.stream_params() == ref.stream_params()
    np.testing.assert_array_equal(m.curve(), ref.curve())


def test_setters_and_region_match_jax():
    m, ref = MaskEditorModel(64), jgui_model.MaskEditorModel(64)
    for op, args in (("set_tdoa", (20.0,)), ("set_window_width", (5.0,)), ("set_beta", (2.0,)),
                     ("set_noise_floor", (0.25,)), ("set_region", (10.0, 30.0)),
                     ("set_region", (40.0, 25.0)), ("set_region", (12.0, 12.0)),
                     ("shift_region", (7.0,)), ("set_tdoa", (1e6,)), ("set_beta", (1e9,)),
                     ("set_tdoa", (62.0,)), ("set_window_width", (20.0,))):
        getattr(m, op)(*args)
        getattr(ref, op)(*args)
        assert (m.center_frac, m.width_frac, m.shape_frac, m.floor_frac) == (
            ref.center_frac, ref.width_frac, ref.shape_frac, ref.floor_frac), op
        assert m.region == ref.region, op
    assert m.region[1] == pytest.approx(63.0)


def test_curve_and_kernel_match_jax():
    n, mu, alpha, beta, floor = 96, 40.0, 6.0, 1.5, 0.2
    x = np.arange(n, dtype=np.float64)
    got = target_window_curve(n, mu, alpha, beta, floor)
    np.testing.assert_array_equal(got, jgui_model.target_window_curve(n, mu, alpha, beta, floor))
    assert got.min() == pytest.approx(floor, abs=1e-6) and got.max() == pytest.approx(1.0)
    np.testing.assert_array_equal(generalized_gaussian(x, alpha, beta, mu),
                                  jgui_model.generalized_gaussian(x, alpha, beta, mu))


def test_visualized_dictionary_matches_jax():
    rng = np.random.default_rng(7)
    w = rng.random((33, 8)).astype(np.float32) + 1e-3
    w[:5, 0] += 5.0
    w[-5:, 3] += 5.0
    img = visualized_dictionary(w)
    np.testing.assert_array_equal(img, jgui_model.visualized_dictionary(w))
    mag = (1.0 - img.astype(np.float64)) ** 3.0
    centroids = (np.arange(33.0)[:, None] * mag).sum(0) / mag.sum(0)
    assert np.all(np.diff(centroids) >= -1e-9) and img.min() == pytest.approx(0.0, abs=1e-6)


@pytest.mark.parametrize("hist", [np.stack([np.linspace(0, 1, 16), 2 * np.linspace(0, 1, 16)]),
                                  np.zeros((0, 16)), np.ones((4, 16))],
                         ids=["ramp", "empty", "flat"])
def test_normalized_mean_gcc_matches_jax(hist):
    got, want = normalized_mean_gcc(hist), jgui_model.normalized_mean_gcc(hist)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- figure view


@pytest.fixture()
def gui_app(tmp_path, stereo_signal):
    mix, sr = stereo_signal
    path = str(tmp_path / "mix.wav")
    wavio.write_wav(mix, path, sr)
    rng = np.random.default_rng(0)
    dicts = {"Pretrained": {16: rng.random((513, 16)).astype(np.float32) + 1e-3,
                            8: rng.random((513, 8)).astype(np.float32) + 1e-3}}
    cfg = load_config(None, dictionary_size=16, dictionary_sizes=(8, 16),
                      localization_enabled=False)
    return RealtimeGCCNMF(path, config=cfg, dictionaries=dicts, device="cpu")


def _blocks(app, n, seed):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        app.process_block(
            rng.standard_normal((2, app.config.block_size)).astype(np.float32) * 0.1)


def _make_view(app):
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure

    from gccnmf_torch.gui import GCCNMFFigureView

    fig = Figure(figsize=(11, 7), dpi=90)
    FigureCanvasAgg(fig)
    changed = []
    view = GCCNMFFigureView(fig, app, on_params_changed=changed.append)
    fig.canvas.draw()  # realize transforms for synthetic mouse events
    return view, fig, changed


def _mouse(fig, ax, name, xdata, ydata=0.5):
    from matplotlib.backend_bases import MouseEvent

    xpix, ypix = ax.transData.transform((xdata, ydata))
    return MouseEvent(name, fig.canvas, xpix, ypix, button=1)


def _param(app, name):
    return float(np.asarray(getattr(app.params, name)))


def test_figure_view_refresh_headless(gui_app):
    view, fig, _ = _make_view(gui_app)
    _blocks(gui_app, 4, 3)
    view.refresh()
    fig.canvas.draw()
    assert "in" in view._images and "dict" in view._images
    np.testing.assert_allclose(np.asarray(view._images["dict"].get_array()),
                               visualized_dictionary(gui_app.peek_dictionary()), rtol=1e-5)
    assert view._gcc_line.get_xdata().size == gui_app.config.num_tdoas
    track = view._tdoa_track.get_ydata()
    assert track.size == gui_app.config.num_tdoa_history and np.isfinite(track).all()


def test_region_drag_updates_engine_params(gui_app):
    view, fig, changed = _make_view(gui_app)
    m = view.model
    m.set_region(20.0, 30.0)
    view._redraw_editor()
    ax = view.ax_curve
    view._on_press(_mouse(fig, ax, "button_press_event", 25.0))
    assert view._drag is not None and view._drag[0] == "move"
    view._on_motion(_mouse(fig, ax, "motion_notify_event", 33.0))
    view._on_release(_mouse(fig, ax, "button_release_event", 33.0))
    assert view._drag is None
    assert m.tdoa == pytest.approx(33.0, abs=0.2) and m.window_width == pytest.approx(5.0, abs=0.2)
    assert _param(gui_app, "target_tdoa_index") == pytest.approx(m.tdoa, abs=1e-4)
    assert _param(gui_app, "target_epsilon") == pytest.approx(m.window_width, abs=1e-4)
    assert changed


def test_region_edge_drag_resizes(gui_app):
    view, fig, _ = _make_view(gui_app)
    m = view.model
    m.set_region(20.0, 30.0)
    view._redraw_editor()
    ax = view.ax_curve
    view._on_press(_mouse(fig, ax, "button_press_event", 30.0))
    assert view._drag is not None and view._drag[0] == "hi"
    view._on_motion(_mouse(fig, ax, "motion_notify_event", 40.0))
    view._on_release(_mouse(fig, ax, "button_release_event", 40.0))
    assert m.region[1] == pytest.approx(40.0, abs=0.2)
    assert m.region[0] == pytest.approx(20.0, abs=0.2)
    assert _param(gui_app, "target_epsilon") == pytest.approx(m.window_width, abs=1e-4)


@pytest.mark.parametrize("case", ["near-edge", "clipped-width", "clipped-center"])
def test_body_drags_at_the_grid_edge(gui_app, case):
    """Translating the region into, or from, a clipped grid edge keeps the
    window width and moves the true center by the drag."""
    view, fig, _ = _make_view(gui_app)
    m = view.model
    n = gui_app.config.num_tdoas
    if case == "near-edge":
        m.set_region(n - 22.0, n - 12.0)
    elif case == "clipped-width":
        m.set_tdoa(n - 2.0)
        m.set_window_width(5.0)
    else:
        m.set_tdoa(1.0)
        m.set_window_width(5.0)
    view._redraw_editor()
    lo, hi = m.region
    grab = (lo + hi) / 2.0
    target = {"near-edge": n - 2.0, "clipped-width": grab - 10.0, "clipped-center": grab + 0.25}
    view._on_press(_mouse(fig, view.ax_curve, "button_press_event", grab))
    assert view._drag is not None and view._drag[0] == "move"
    view._on_motion(_mouse(fig, view.ax_curve, "motion_notify_event", target[case]))
    view._on_release(None)
    assert m.window_width == pytest.approx(5.0, abs=0.2)
    if case == "clipped-center":
        assert m.tdoa == pytest.approx(1.25, abs=1e-6)
    assert _param(gui_app, "target_epsilon") == pytest.approx(m.window_width, abs=1e-4)


def test_tdoa_track_stays_on_axes_after_refresh(gui_app):
    view, fig, _ = _make_view(gui_app)
    _blocks(gui_app, 3, 7)
    for _ in range(2):
        view.refresh()
        fig.canvas.draw()
        assert view._tdoa_track.axes is view.ax_gcc and view._tdoa_track in view.ax_gcc.lines
    small = np.asarray(view._images["gcc"].get_array())[:, :4]
    view._imshow(view.ax_gcc, "gcc", small)
    assert view._tdoa_track in view.ax_gcc.lines


def test_disabling_localization_hands_center_to_engine(gui_app):
    view, _, _ = _make_view(gui_app)
    view.set_localization(True)
    _blocks(gui_app, 5, 21)
    view.refresh()
    followed = view.model.tdoa
    view.set_localization(False)
    assert _param(gui_app, "target_tdoa_index") == pytest.approx(followed, abs=1e-4)


def test_slider_edits_move_region_and_curve(gui_app):
    view, _, _ = _make_view(gui_app)
    view.set_model_params(tdoa=12.0, width=4.0, beta=2.5, noise_floor=0.3)
    assert view.model.region == (pytest.approx(8.0), pytest.approx(16.0))
    patch = view._region_patch
    if hasattr(patch, "get_width"):
        span = (patch.get_x(), patch.get_x() + patch.get_width())
    else:
        xs = patch.get_xy()[:, 0]
        span = (xs.min(), xs.max())
    assert span == (pytest.approx(8.0), pytest.approx(16.0))
    assert view._curve_line.get_ydata().min() == pytest.approx(0.3, abs=1e-5)
    assert _param(gui_app, "target_beta") == pytest.approx(2.5)
    assert _param(gui_app, "noise_floor") == pytest.approx(0.3)


def test_localization_follow_drives_center(gui_app):
    view, fig, changed = _make_view(gui_app)
    gui_app.set_localization(True, window_size=4)
    _blocks(gui_app, 6, 5)
    width_before = view.model.window_width
    view.refresh()
    tdoa = gui_app.histories["tdoa"].get(1)
    assert view.model.tdoa == pytest.approx(float(tdoa[-1]), abs=1e-4)
    assert view.model.window_width == pytest.approx(width_before) and changed
    view.model.set_window_width(6.0)
    view._redraw_editor()
    view._on_press(_mouse(fig, view.ax_curve, "button_press_event", view.model.tdoa))
    assert view._drag is None  # the body belongs to localization
    view._on_press(_mouse(fig, view.ax_curve, "button_press_event", view.model.region[1]))
    assert view._drag is not None and view._drag[0] == "hi"


def test_per_size_mask_histories_persist_across_switches(gui_app):
    _blocks(gui_app, 3, 9)
    h16 = gui_app.histories["coefficient_mask"]
    filled = h16.num_values
    assert filled > 0
    gui_app.set_dictionary(size=8)
    _blocks(gui_app, 2, 10)
    h8 = gui_app.histories["coefficient_mask"]
    assert h8 is not h16 and h8.get_unraveled().shape[1] == 8
    assert gui_app.mask_histories[16] is h16 and h16.num_values == filled
    gui_app.set_dictionary(size=16)
    assert gui_app.histories["coefficient_mask"] is h16


def test_figure_view_tracks_dictionary_switch(gui_app):
    view, _, _ = _make_view(gui_app)
    _blocks(gui_app, 1, 11)
    view.refresh()
    assert np.asarray(view._images["dict"].get_array()).shape[1] == 16
    gui_app.set_dictionary(size=8)
    _blocks(gui_app, 1, 12)
    view.refresh()
    assert np.asarray(view._images["dict"].get_array()).shape[1] == 8
    assert np.asarray(view._images["mask"].get_array()).shape[0] == 8


# ------------------------------------------------------ Tk shell (stub Tk)


class _RecordingStream:
    def __init__(self):
        self.blocks, self.closed, self.underruns, self.overruns = [], False, 0, 0

    def write(self, block):
        self.blocks.append(np.asarray(block, np.float32).copy())
        return True

    def close(self):
        self.closed = True


def _make_window(app, loop=False):
    from gccnmf_torch.gui import RealtimeGCCNMFWindow

    stream = _RecordingStream()
    win = RealtimeGCCNMFWindow(app, loop=loop, tk_module=fake_tk,
                               canvas_factory=fake_tk.FakeCanvasTkAgg, output_stream=stream)
    return win, stream


def _wait_until(predicate, timeout_s=10.0):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout_s:
        if predicate():
            return True
        time.sleep(0.01)
    return False


def _walk(widget):
    yield widget
    for child in widget.children:
        yield from _walk(child)


def test_stub_window_builds_and_refreshes(gui_app):
    win, _ = _make_window(gui_app)
    try:
        assert win.play_btn.options["text"] == "Play"
        for w in (win.s_center, win.s_width, win.s_shape, win.s_floor):
            assert w.packed and "command" in w.options
        assert win.root.after_calls
        _blocks(gui_app, 2, 2)
        win.root.run_after_callbacks()
        assert win.root.after_calls and "in" in win.view._images
    finally:
        win.close()
    assert win.root.destroyed


def test_stub_window_toggle_play_restart_logic(gui_app):
    win, _ = _make_window(gui_app, loop=False)
    try:
        win.toggle_play()
        worker = win._worker
        assert win.play_btn.options["text"] == "Pause" and worker.is_alive()
        win.toggle_play()
        assert win.play_btn.options["text"] == "Play" and not win._playing.is_set()
        win.toggle_play()
        assert win._playing.is_set()
        assert _wait_until(lambda: not worker.is_alive(), timeout_s=60.0)
        win.toggle_play()
        assert win._worker is not worker and win._worker.is_alive()
        assert win.play_btn.options["text"] == "Pause"
    finally:
        win.close()


def test_stub_window_pump_plays_enhanced_blocks(gui_app):
    win, stream = _make_window(gui_app, loop=True)
    try:
        win.toggle_play()
        assert _wait_until(lambda: len(stream.blocks) >= 4, timeout_s=60.0)
    finally:
        win.close()
    for b in stream.blocks:
        assert b.shape == (2, gui_app.config.block_size) and np.isfinite(b).all()
    assert stream.closed


def test_stub_window_pump_error_surfaces_on_status_line(gui_app, tmp_path):
    mono = str(tmp_path / "mono.wav")
    wavio.write_wav(np.zeros((1, 8192), np.float32) + 0.01, mono, 16000)
    gui_app.audio_path = mono
    win, _ = _make_window(gui_app)
    try:
        win.toggle_play()
        assert _wait_until(lambda: win._pump_error is not None and not win._worker.is_alive(),
                           timeout_s=30.0)
        win.root.run_after_callbacks()
        assert "channel" in win.status_var.get()
        assert win.play_btn.options["text"] == "Play"
    finally:
        win.close()


def test_stub_window_status_line_shows_live_health(gui_app):
    win, stream = _make_window(gui_app, loop=True)
    try:
        assert win.status_var.get() == "idle"
        win.toggle_play()
        assert _wait_until(lambda: win.blocks_processed >= 3, timeout_s=60.0)
        win._playing.clear()
        stream.underruns = 2
        win.root.run_after_callbacks()
        text = win.status_var.get()
        for part in ("blocks", "proc", "deadline misses", "underruns 2", "overruns",
                     " | mem ", "MiB"):
            assert part in text, part
        assert "RECYCLE" not in text
    finally:
        win.close()


def test_stub_window_callbacks_reach_the_app(gui_app):
    win, _ = _make_window(gui_app)
    try:
        dict_menu = next(w for w in _walk(win.root) if w.__class__.__name__ == "OptionMenu"
                         and getattr(w, "variable", None) is win.dict_var)
        dict_menu.select("8")
        assert win.app.dictionary_size == 8
        h_spin = next(w for w in _walk(win.root) if w.__class__.__name__ == "Spinbox"
                      and w.options.get("textvariable") is win.h_var)
        h_spin.set_and_fire(2)
        assert win.app.config.num_h_updates == 2
        win.s_center.drag_to(20.0)
        assert _param(win.app, "target_tdoa_index") == pytest.approx(20.0, abs=0.5)
        assert "<space>" in win.root.bindings
        win.root.bindings["<space>"](None)
        assert win._worker is not None and win._worker.is_alive()
        win.root.bindings["<space>"](None)
        assert not win._playing.is_set()
        win.loc_var.set(True)
        win._set_localization(True)
        assert win.s_center.options.get("state") == "disabled"
        win._set_localization(False)
        assert win.s_center.options.get("state") == "normal"
    finally:
        win.close()


def test_stub_window_close_is_idempotent_from_protocol(gui_app):
    win, stream = _make_window(gui_app)
    win.toggle_play()
    win.root.protocols["WM_DELETE_WINDOW"]()
    assert win.root.destroyed and stream.closed and win._stop.is_set()
    assert not win._worker.is_alive()


def test_run_gui_builds_the_ports_app(gui_app, monkeypatch):
    """run_gui builds the port's app on the requested device and enters the
    window's main loop."""
    import gccnmf_torch.gui as gui

    seen = []

    class Window:
        def __init__(self, app, loop):
            seen.append((app, loop))

        def run(self):
            seen.append("ran")

    monkeypatch.setattr(gui, "RealtimeGCCNMFWindow", Window)
    gui.run_gui(gui_app.audio_path, config=gui_app.config, loop=False, device="cpu")
    (app, loop), ran = seen
    assert isinstance(app, RealtimeGCCNMF) and app.device.type == "cpu"
    assert loop is False and ran == "ran"
