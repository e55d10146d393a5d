"""Interactive realtime GUI (matplotlib view + tkinter shell; counterpart of
``gccnmf_tpu/gui.py``).

Functional parity with the reference's Qt/pyqtgraph window
(reference: gccNMF/realtime/gccNMFInterface.py:40-529): rolling
input/output spectrograms, GCC-PHAT angular waterfall with the localized
TDOA track, centroid-ordered dictionary image, per-dictionary-size
coefficient-mask waterfalls, the mask-function editor — a draggable
target-TDOA region with the generalized-Gaussian window curve drawn over
the live mean-GCC-PHAT plot, two-way-bound to center/width/shape/floor
sliders (gccNMFInterface.py:256-274, 469-477, 534-578) — a
dictionary-size selector, localization and separation toggles, and
play/pause. Rebuilt on tkinter + matplotlib in place of Qt/pyqtgraph;
both are imported only when a window or figure is built, so the module
imports on a machine with neither.

The module is split so widget logic runs without a display:

- :class:`gccnmf_torch.gui_model.MaskEditorModel` — pure-NumPy parameter
  mappings (slider ↔ (μ, α, β, floor) ↔ region);
- :class:`GCCNMFFigureView` — all matplotlib rendering and the
  mouse-drag region editor, backend-agnostic (tests drive it on Agg with
  synthetic mouse events);
- :class:`RealtimeGCCNMFWindow` — the thin Tk shell: canvas, sliders,
  buttons, keyboard shortcuts, and the audio pump thread.

Architecture mirrors the headless app exactly: a worker thread pumps
blocks through :class:`gccnmf_torch.realtime.app.RealtimeGCCNMF` (device
compute); the GUI thread repaints from the app's host-side history ring
buffers on a timer, and reads only host values (the app's ``params``, its
host copy of the dictionary), so it never reaches the card while the
pump captures a new engine's graph. Reads are unsynchronized by design — the same
tearing-tolerant telemetry contract as the reference's shared-memory GUI
reads (gccNMFInterface.py:385-405). Parameter widgets call the app's hot
(`set_target_window`, toggles — nothing re-captured) or structural
(`set_dictionary` — engine rebuild) control paths between blocks.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque

import numpy as np

from gccnmf_torch.gui_model import (
    MaskEditorModel,
    normalized_mean_gcc,
    visualized_dictionary,
)

logger = logging.getLogger(__name__)

__all__ = ["GCCNMFFigureView", "RealtimeGCCNMFWindow", "run_gui"]

_REFRESH_MS = 100  # reference uses a 100 ms plot timer (gccNMFInterface.py:69)

#: hit radius (fraction of the TDOA grid) for grabbing a region edge
_EDGE_GRAB_FRAC = 0.02


class GCCNMFFigureView:
    """Matplotlib rendering + mask-editor interaction for a realtime app.

    Backend-agnostic: give it any ``matplotlib.figure.Figure`` (Agg in
    tests, TkAgg in the window) and it owns the six panels, the
    mask-function editor overlay, and the mouse handlers for dragging the
    target-TDOA region (move by grabbing the body, resize by grabbing an
    edge — the LinearRegionItem interaction of the reference,
    gccNMFInterface.py:268-270).

    ``on_params_changed(model)`` fires whenever the model changed from the
    figure side (drag or localization follow) so the shell can sync its
    sliders; pushes to the engine go through ``app.set_target_window``.
    """

    def __init__(self, fig, app, on_params_changed=None):
        self.fig = fig
        self.app = app
        self.on_params_changed = on_params_changed
        cfg = app.config

        p = app.params
        self.model = MaskEditorModel(cfg.num_tdoas)
        self.model.set_tdoa(float(np.asarray(p.target_tdoa_index)))
        self.model.set_window_width(float(np.asarray(p.target_epsilon)))
        self.model.set_beta(float(np.asarray(p.target_beta)))
        self.model.set_noise_floor(float(np.asarray(p.noise_floor)))

        grid = fig.add_gridspec(2, 3)
        self.ax_in = fig.add_subplot(grid[0, 0])
        self.ax_out = fig.add_subplot(grid[0, 1])
        self.ax_dict = fig.add_subplot(grid[0, 2])
        self.ax_gcc = fig.add_subplot(grid[1, 0])
        self.ax_curve = fig.add_subplot(grid[1, 1])
        self.ax_mask = fig.add_subplot(grid[1, 2])
        try:
            fig.set_layout_engine("tight")
        except Exception:  # older matplotlib
            fig.set_tight_layout(True)

        # mask-function editor panel: live mean GCC-PHAT (black), window
        # curve (blue), draggable span, localized-TDOA marker
        ax = self.ax_curve
        ax.set_xlim(0, cfg.num_tdoas - 1)
        ax.set_ylim(-0.05, 1.05)
        ax.set_title("mean GCC-PHAT + target window", fontsize=9)
        ax.set_xticks([])
        ax.set_yticks([])
        (self._gcc_line,) = ax.plot([], [], color="k", linewidth=1.0)
        (self._curve_line,) = ax.plot([], [], color="tab:blue", linewidth=2.0)
        # localized-TDOA track drawn over the GCC waterfall (reference
        # tdoaPlotDataItem, gccNMFInterface.py:391-399)
        (self._tdoa_track,) = self.ax_gcc.plot(
            [], [], color="w", linewidth=1.0, alpha=0.9
        )
        lo, hi = self.model.region
        self._region_patch = ax.axvspan(lo, hi, color="tab:blue", alpha=0.18)
        self._tdoa_marker = ax.axvline(
            self.model.tdoa, color="r", linewidth=1.0, alpha=0.8
        )
        self._redraw_editor()

        self._images: dict = {}
        self._dict_cache_key = None
        self._drag: tuple | None = None  # ("move"|"lo"|"hi", grab_x, lo0, hi0)
        fig.canvas.mpl_connect("button_press_event", self._on_press)
        fig.canvas.mpl_connect("motion_notify_event", self._on_motion)
        fig.canvas.mpl_connect("button_release_event", self._on_release)

    # -------------------------------------------------------------- editing

    def _localization_on(self) -> bool:
        return bool(np.asarray(self.app.params.localization_enabled))

    def set_model_params(
        self,
        tdoa: float | None = None,
        width: float | None = None,
        beta: float | None = None,
        noise_floor: float | None = None,
    ) -> None:
        """Slider side of the two-way binding: update the model, push the
        hot params to the engine, move the region/curve on the plot."""
        if tdoa is not None:
            self.model.set_tdoa(tdoa)
        if width is not None:
            self.model.set_window_width(width)
        if beta is not None:
            self.model.set_beta(beta)
        if noise_floor is not None:
            self.model.set_noise_floor(noise_floor)
        self._push_params()
        self._redraw_editor()

    def _push_params(self) -> None:
        self.app.set_target_window(**self.model.stream_params())

    def set_localization(self, enabled: bool) -> None:
        """Toggle online localization. On disable, hand the followed center
        back to the engine: while localization owned the target the model
        tracked it but params were never pushed — without this the mask
        would snap back to the stale manually-set index."""
        self.app.set_localization(enabled)
        if not enabled:
            self._push_params()
            self._redraw_editor()

    def _redraw_editor(self) -> None:
        lo, hi = self.model.region
        patch = self._region_patch
        if hasattr(patch, "set_width"):  # Rectangle (matplotlib >= 3.8)
            patch.set_x(lo)
            patch.set_width(hi - lo)
        else:  # Polygon (older axvspan): x of the 4 (or 5 closed) vertices
            xy = patch.get_xy()
            xy[:, 0] = [lo, lo, hi, hi, lo][: xy.shape[0]]
            patch.set_xy(xy)
        curve = self.model.curve()
        self._curve_line.set_data(np.arange(curve.size), curve)
        self._tdoa_marker.set_xdata([self.model.tdoa, self.model.tdoa])

    def _grab_zone(self, x: float) -> str | None:
        """Which part of the region is at x: 'lo'/'hi' edge, 'move' body."""
        lo, hi = self.model.region
        tol = self.model.num_tdoas * _EDGE_GRAB_FRAC
        if abs(x - lo) <= tol:
            return "lo"
        if abs(x - hi) <= tol:
            return "hi"
        if lo < x < hi:
            return "move"
        return None

    def _on_press(self, event) -> None:
        if event.inaxes is not self.ax_curve or event.xdata is None:
            return
        zone = self._grab_zone(float(event.xdata))
        # with online localization driving the center, the center is not
        # user-editable (reference disables the TDOA slider,
        # gccNMFInterface.py:515-517); edge resizes stay allowed
        if zone == "move" and self._localization_on():
            return
        if zone is not None:
            lo, hi = self.model.region
            # capture the true width AND center at press time: the visible
            # region may be clipped at a grid edge, and deriving either
            # from (lo, hi) during a body drag would permanently narrow
            # epsilon / teleport the center to the clipped span's middle
            self._drag = (zone, float(event.xdata), lo, hi,
                          float(self.model.window_width),
                          float(self.model.tdoa))

    def _on_motion(self, event) -> None:
        if self._drag is None or event.xdata is None:
            return
        if event.inaxes is not self.ax_curve:
            return
        zone, x0, lo0, hi0, width0, tdoa0 = self._drag
        x = float(event.xdata)
        if zone == "move":
            # width-preserving translation (pyqtgraph LinearRegionItem
            # semantics): set_region against a grid edge would clip one
            # bound and permanently narrow epsilon — restore the width
            # and translate the TRUE center captured at press time, not
            # the clipped span's middle
            self.model.set_tdoa(tdoa0 + (x - x0))
            self.model.set_window_width(width0)
        elif zone == "lo":
            self.model.set_region(x, hi0)
        else:  # "hi"
            self.model.set_region(lo0, x)
        self._push_params()
        self._redraw_editor()
        if self.on_params_changed:
            self.on_params_changed(self.model)

    def _on_release(self, _event) -> None:
        self._drag = None

    # ------------------------------------------------------------ rendering

    def _imshow(self, ax, key, data, cmap="magma", title=None, clim=None):
        # Never ax.clear() here: ax_gcc also carries the localized-TDOA
        # track line, and clearing would detach it (its set_data would then
        # update an artist no longer on any axes). Remove only stale images.
        if key in self._images and (
            self._images[key].get_array().shape != data.shape
        ):
            self._images[key].remove()
            del self._images[key]
        if key not in self._images:
            self._images[key] = ax.imshow(
                data, origin="lower", aspect="auto", cmap=cmap
            )
            if title:
                ax.set_title(title, fontsize=9)
            ax.set_xticks([])
            ax.set_yticks([])
        img = self._images[key]
        img.set_data(data)
        if clim is not None:
            img.set_clim(*clim)
        else:
            img.set_clim(float(data.min()), float(data.max()) + 1e-9)

    def refresh(self) -> None:
        """Repaint every panel from the app's history rings (the 100 ms
        timer body; reference updateGCCPHATPlot, gccNMFInterface.py:385-405)."""
        app = self.app
        h = app.histories
        compress = lambda x: np.power(np.abs(x), 1.0 / 3.0)
        self._imshow(
            self.ax_in, "in", compress(h["input_spectrogram"].get_unraveled().T),
            title="input spectrogram",
        )
        self._imshow(
            self.ax_out, "out", compress(h["output_spectrogram"].get_unraveled().T),
            title="output spectrogram",
        )
        gcc_wf = h["gcc_phat"].get_unraveled().T
        self._imshow(self.ax_gcc, "gcc", gcc_wf, title="GCC-PHAT waterfall")
        track = h["tdoa"].get_unraveled()
        self._tdoa_track.set_data(np.arange(track.size), track)
        self.ax_gcc.set_xlim(0, max(track.size - 1, 1))
        self.ax_gcc.set_ylim(0, gcc_wf.shape[0] - 1)
        # the active size's waterfall; switching sizes swaps the ring and the
        # old one keeps its history (reference per-size buffers,
        # runRealtimeGCCNMF.py:74-81); levels pinned to [0,1] like the
        # reference's setImage(levels=[0,1])
        self._imshow(
            self.ax_mask, "mask", h["coefficient_mask"].get_unraveled().T,
            cmap="gray", title=f"coefficient mask (K={app.dictionary_size})",
            clim=(0.0, 1.0),
        )
        # peek, never build: app.processor on this (GUI) thread would race
        # the audio pump's locked lazy rebuild after a structural change;
        # the peek is a host copy, so the card is not touched either
        w = app.peek_dictionary()
        if w is not None:
            key = (app.dictionary_type, app.dictionary_size, w.shape)
            if key != self._dict_cache_key:
                self._dict_w_img = visualized_dictionary(w)
                self._dict_cache_key = key
            self._imshow(
                self.ax_dict, "dict", self._dict_w_img, cmap="gray",
                title="dictionary W (centroid-ordered)", clim=(0.0, 1.0),
            )

        # live mean GCC-PHAT under the editor curve
        window = int(np.asarray(app.params.localization_window))
        curve = normalized_mean_gcc(h["gcc_phat"].get(window))
        if curve is not None:
            self._gcc_line.set_data(np.arange(curve.size), curve)

        # online localization drives the window center: model + region +
        # shell sliders follow the localized TDOA (reference
        # gccNMFInterface.py:403-405)
        if self._localization_on():
            tdoa = h["tdoa"].get(1)
            if tdoa.size:
                width = self.model.window_width
                self.model.set_tdoa(float(tdoa[-1]))
                self.model.set_window_width(width)
                self._redraw_editor()
                if self.on_params_changed:
                    self.on_params_changed(self.model)


class RealtimeGCCNMFWindow:
    """Tk shell around a :class:`RealtimeGCCNMF` app + figure view.

    ``tk_module`` and ``canvas_factory`` are injectable so the widget
    wiring (toggle_play restart logic, spinbox/dropdown callbacks, the
    close path) runs headlessly in the test suite against a stub Tk — only
    the literal ``mainloop()`` needs a display. ``output_stream`` is a live
    audio sink (``write(block)``; see
    :class:`gccnmf_torch.realtime.audio.CallbackOutputStream`); by default
    the window asks :func:`open_output_stream` for a device-backed one and
    plays enhanced blocks through it like the reference's callback-clocked
    stream (audioProcessor.py:106-132) — without an audio stack the pump
    discards output, as before."""

    def __init__(self, app, loop: bool = True, tk_module=None,
                 canvas_factory=None, output_stream=None):
        if tk_module is None:
            import tkinter as tk_module
        tk = tk_module
        if canvas_factory is None:
            from matplotlib.backends.backend_tkagg import (
                FigureCanvasTkAgg as canvas_factory,
            )
        from matplotlib.figure import Figure

        self.app = app
        self.loop = loop
        self._playing = threading.Event()
        self._stop = threading.Event()
        self._worker: threading.Thread | None = None
        # live-output health, written by the pump thread and rendered by
        # the 100 ms refresh timer (reference analogue: the audio
        # process's 2 s processing-time log, audioProcessor.py:98-102);
        # plain int/deque updates are GIL-atomic enough for telemetry
        self.blocks_processed = 0
        self.deadline_misses = 0
        self._proc_times: deque = deque(maxlen=64)
        self._pump_error: str | None = None  # rendered on the status line
        from gccnmf_torch.utils.hostmem import HostMemWatchdog

        self._mem_watchdog = HostMemWatchdog()
        if output_stream is None:
            from gccnmf_torch.realtime.audio import open_output_stream

            cfg = app.config
            output_stream = open_output_stream(
                cfg.sample_rate, cfg.num_channels, cfg.block_size
            )  # None without a host audio stack → pump discards output
        self.output_stream = output_stream

        self.root = tk.Tk()
        self.root.title("RT-GCC-NMF")
        self.root.protocol("WM_DELETE_WINDOW", self.close)

        fig = Figure(figsize=(11, 7), dpi=90)
        self.canvas = canvas_factory(fig, master=self.root)
        self.view = GCCNMFFigureView(fig, app, on_params_changed=self._sync_sliders)
        self.canvas.get_tk_widget().pack(side=tk.TOP, fill=tk.BOTH, expand=1)

        self._build_controls(tk)
        # keyboard shortcuts (reference gccNMFInterface.py keyboard handling):
        # space = play/pause, s = separation toggle, l = localization toggle
        self.root.bind("<space>", lambda _e: self.toggle_play())
        self.root.bind("s", lambda _e: self._toggle_check(self.sep_var,
                       lambda v: self.app.set_separation_enabled(v)))
        self.root.bind("l", lambda _e: self._toggle_check(self.loc_var,
                       lambda v: self._set_localization(v)))
        self.root.after(_REFRESH_MS, self._refresh)

    @staticmethod
    def _toggle_check(var, setter):
        var.set(not var.get())
        setter(var.get())

    # --------------------------------------------------------------- widgets

    def _build_controls(self, tk):
        cfg = self.app.config
        model = self.view.model
        # status line: live-output health (block count, processing time,
        # deadline misses, output underruns/overruns) — the window-borne
        # version of the reference's periodic processing-time log
        status = tk.Frame(self.root)
        status.pack(side=tk.BOTTOM, fill=tk.X)
        self.status_var = tk.StringVar(value="idle")
        tk.Label(status, textvariable=self.status_var, anchor="w").pack(
            side=tk.LEFT, padx=4
        )
        bar = tk.Frame(self.root)
        bar.pack(side=tk.BOTTOM, fill=tk.X)

        self.play_btn = tk.Button(bar, text="Play", command=self.toggle_play)
        self.play_btn.pack(side=tk.LEFT, padx=4)

        self.sep_var = tk.BooleanVar(value=True)
        tk.Checkbutton(
            bar, text="separation", variable=self.sep_var,
            command=lambda: self.app.set_separation_enabled(self.sep_var.get()),
        ).pack(side=tk.LEFT)

        self.loc_var = tk.BooleanVar(value=bool(cfg.localization_enabled))
        tk.Checkbutton(
            bar, text="localization", variable=self.loc_var,
            command=lambda: self._set_localization(self.loc_var.get()),
        ).pack(side=tk.LEFT)
        # sliding-window length for the online localizer (reference
        # localziaitonWindowSizeSpinBox, gccNMFInterface.py:303-311)
        self.loc_win_var = tk.IntVar(value=int(cfg.localization_window_size))
        tk.Spinbox(
            bar, from_=1, to=int(cfg.num_tdoa_history), width=3,
            textvariable=self.loc_win_var,
            command=lambda: self.app.set_localization(
                self.loc_var.get(), window_size=int(self.loc_win_var.get())
            ),
        ).pack(side=tk.LEFT)

        def slider(name, frm, to, init, cmd, resolution=0.1):
            tk.Label(bar, text=name).pack(side=tk.LEFT, padx=(8, 0))
            s = tk.Scale(
                bar, from_=frm, to=to, resolution=resolution,
                orient=tk.HORIZONTAL, length=110, showvalue=True,
            )
            s.set(init)
            s.configure(command=lambda _v: cmd(float(s.get())))
            s.pack(side=tk.LEFT)
            return s

        # mask-window sliders: center/width/shape/floor — two-way bound to
        # the draggable region through the shared MaskEditorModel
        # (reference TargetWindowFunctionPlot, gccNMFInterface.py:534-578)
        self._syncing = False
        view = self.view
        self.s_center = slider(
            "center", 0, cfg.num_tdoas - 1, model.tdoa,
            lambda v: self._slider_edit(tdoa=v),
        )
        self.s_width = slider(
            "width", 0.5, cfg.num_tdoas / 2.0, model.window_width,
            lambda v: self._slider_edit(width=v),
        )
        self.s_shape = slider(
            "shape", 0.25, 8.0, model.beta,
            lambda v: self._slider_edit(beta=v),
        )
        self.s_floor = slider(
            "floor", 0.0, 1.0, model.noise_floor,
            lambda v: self._slider_edit(noise_floor=v), resolution=0.01,
        )
        if bool(cfg.localization_enabled):
            self.s_center.configure(state="disabled")

        tk.Label(bar, text="dict").pack(side=tk.LEFT, padx=(8, 0))
        self.dict_var = tk.StringVar(value=str(self.app.dictionary_size))
        tk.OptionMenu(
            bar, self.dict_var,
            *[str(s) for s in cfg.dictionary_sizes],
            command=lambda v: self.app.set_dictionary(size=int(v)),
        ).pack(side=tk.LEFT)
        # Pretrained vs Random dictionary bank (reference
        # dictionaryTypeChanged, gccNMFInterface.py:506-513)
        self.dict_type_var = tk.StringVar(value=str(self.app.dictionary_type))
        tk.OptionMenu(
            bar, self.dict_type_var, "Pretrained", "Random",
            command=lambda v: self.app.set_dictionary(type=str(v)),
        ).pack(side=tk.LEFT)

        # per-block H-inference steps (reference shows this spinbox but its
        # engine never uses the value, gccNMFInterface.py:290-292; here it
        # actually switches the mask — a structural rebuild between blocks)
        tk.Label(bar, text="H upd").pack(side=tk.LEFT, padx=(8, 0))
        self.h_var = tk.IntVar(value=int(getattr(cfg, "num_h_updates", 0)))
        tk.Spinbox(
            bar, from_=0, to=50, width=3, textvariable=self.h_var,
            command=lambda: self.app.set_num_h_updates(int(self.h_var.get())),
        ).pack(side=tk.LEFT)

    def _slider_edit(self, **kw):
        if self._syncing:
            return
        self.view.set_model_params(**kw)

    def _sync_sliders(self, model) -> None:
        """Figure → sliders half of the two-way binding (drag, follow)."""
        self._syncing = True
        try:
            self.s_center.set(model.tdoa)
            self.s_width.set(model.window_width)
        finally:
            self._syncing = False

    def _set_localization(self, enabled: bool) -> None:
        """Online localization owns the window center while enabled: the
        center slider greys out, the region follows the localized TDOA
        (reference localizationStateChanged, gccNMFInterface.py:514-521)."""
        self.view.set_localization(enabled)
        self.s_center.configure(state="disabled" if enabled else "normal")

    # ----------------------------------------------------------------- audio

    def _pump(self):
        from gccnmf_torch.realtime.audio import FilePlayerSource

        cfg = self.app.config
        source = FilePlayerSource(
            self.app.audio_path, cfg.block_size, loop=self.loop, realtime=True
        )
        if source.num_channels != cfg.num_channels:
            logger.error(
                "input has %d channel(s); engine needs %d — not playing",
                source.num_channels, cfg.num_channels,
            )
            # surface in the window (rendered by the GUI-thread status
            # refresh — a logger line is invisible in a GUI session) and
            # reset the Play button instead of leaving a dead "Pause"
            self._pump_error = (
                f"error: input has {source.num_channels} channel(s); "
                f"need {cfg.num_channels}"
            )
            self._playing.clear()
            return
        stream = self.output_stream
        deadline = cfg.block_size / cfg.sample_rate
        for block in source.blocks():
            if self._stop.is_set():
                return
            self._playing.wait()
            if self._stop.is_set():
                return
            t0 = time.perf_counter()
            out = self.app.process_block(block)
            dt = time.perf_counter() - t0
            self._proc_times.append(dt)
            self.blocks_processed += 1
            if dt > deadline:
                self.deadline_misses += 1
            # play the enhanced block live (the reference demo's entire
            # point: audioProcessor.py:106-132); without an audio backend
            # stream is None and the output is discarded as before. The
            # close path joins with a timeout, so a block that was still
            # being captured when the window closed must not touch the
            # (closed) stream.
            if self._stop.is_set():
                return
            if out is not None and stream is not None:
                stream.write(out)
        if stream is not None:  # file ended: drain the dispatch pipeline
            for out in self.app.flush():
                stream.write(out)

    def toggle_play(self):
        # a dead worker (file ended with loop=False, or the pump died)
        # must be restartable, not a permanently stuck "Pause" button
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._pump, daemon=True)
            self._playing.set()
            self._worker.start()
            self.play_btn.configure(text="Pause")
        elif self._playing.is_set():
            self._playing.clear()
            self.play_btn.configure(text="Play")
        else:
            self._playing.set()
            self.play_btn.configure(text="Pause")

    # ------------------------------------------------------------------ draw

    def _refresh(self):
        if self._stop.is_set():
            return
        # re-arm FIRST: an exception in a single repaint must not kill
        # the 100 ms timer for the rest of the session
        self.root.after(_REFRESH_MS, self._refresh)
        self.view.refresh()
        self._update_status()
        self.canvas.draw_idle()

    def _update_status(self):
        """Render live-output health into the status line (reference
        analogue: min/max/avg block processing time logged every 2 s,
        audioProcessor.py:98-102 — plus the deadline/underrun accounting
        the reference never surfaced)."""
        if self._pump_error:
            self.status_var.set(self._pump_error)
            if self.play_btn.cget("text") == "Pause":
                self.play_btn.configure(text="Play")
            return
        if not self.blocks_processed:
            return
        try:
            times = list(self._proc_times)
        except RuntimeError:
            # the pump thread appended mid-iteration ("deque mutated
            # during iteration") — skip this 100 ms tick, the next one
            # will see a quiescent window
            return
        text = (
            f"blocks {self.blocks_processed}"
            f" | proc {np.mean(times) * 1e3:.1f} ms"
            f" (min {np.min(times) * 1e3:.1f} / max {np.max(times) * 1e3:.1f})"
            if times
            else f"blocks {self.blocks_processed}"
        )
        text += f" | deadline misses {self.deadline_misses}"
        stream = self.output_stream
        if stream is not None:
            text += (
                f" | underruns {getattr(stream, 'underruns', 0)}"
                f" | overruns {getattr(stream, 'overruns', 0)}"
            )
        # host-memory watchdog: a days-long GUI session should see the
        # process's growth and the recycle signal, same as serving
        # telemetry
        mem = self._mem_watchdog.check()
        text += f" | mem {mem['anon_mib']:.0f} MiB"
        if mem["exceeded"]:
            text += " (RECYCLE: over budget)"
        self.status_var.set(text)

    # ------------------------------------------------------------- lifecycle

    def run(self):
        self.root.mainloop()

    def close(self):
        self._stop.set()
        self._playing.set()  # release a paused worker so it can exit
        if self._worker is not None:
            self._worker.join(timeout=2.0)
        if self.output_stream is not None:
            self.output_stream.close()
        self.root.destroy()


def run_gui(audio_path: str | None = None, config_path: str | None = None,
            loop: bool = True, config=None, device=None):
    """Build the app + window and enter the Tk main loop.

    ``config`` (a :class:`gccnmf_torch.config.GCCNMFConfig`) takes
    precedence over ``config_path`` so CLI-built configs (e.g. carrying
    ``--dictionary-file``) reach the app intact. ``device=None`` runs the
    app on the card (and raises without one)."""
    from gccnmf_torch.realtime.app import RealtimeGCCNMF

    app = RealtimeGCCNMF(audio_path, config_path, config=config, device=device)
    win = RealtimeGCCNMFWindow(app, loop=loop)
    win.run()
