"""Interactive viewer: orbit camera, live segmentation and live training
(JAX: sanerf_tpu/apps/gui.py).

`HeadlessViewer` is the viewer's loop without a window, over
`InteractiveSession`: orbit / pan / zoom, right-click prompts, frame
timing and fps, the display mode, background and live AABB, and two
feedback controllers (`AdaptiveController`): the training steps a frame
aim at 500 ms, the render downscale at 200 ms a frame. With a trainer and
a dataset it steps the trainer between frames (`Trainer.train_step`) and
shows its EMA weights; with a static camera it accumulates up to
`max_spp` jittered renders (`InteractiveSession.step(spp=...,
generator=...)`).

`launch_gui` opens the dearpygui window (`_run_dearpygui`, the same loop
with a texture, a control panel and mouse handlers) when dearpygui
imports, else runs the headless loop for 10 orbiting 512^2 frames and
writes them as PNGs under `<workspace>/gui_frames`. No machine this
package is tested on has dearpygui, so `_run_dearpygui` is ported as it
stands and has not run. The renders take the CUDA kernels on the card.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from sanerf_tpu_torch.apps.interactive import InteractiveSession
from sanerf_tpu_torch.config import Config
from sanerf_tpu_torch.train.trainer import save_png
from sanerf_tpu_torch.utils.camera import OrbitCamera


class AdaptiveController:
    """Training steps a frame towards `target_train_ms`, render downscale
    towards `target_render_ms`."""

    def __init__(self, target_train_ms: float = 500.0,
                 target_render_ms: float = 200.0):
        self.target_train_ms = target_train_ms
        self.target_render_ms = target_render_ms
        self.train_steps = 16
        self.downscale = 1

    def update_train_steps(self, elapsed_ms: float):
        full_t = elapsed_ms / max(self.train_steps, 1)
        train_steps = min(16, max(4, int(16 * self.target_train_ms / max(
            full_t * 16, 1e-3))))
        if (train_steps > self.train_steps * 1.2
                or train_steps < self.train_steps * 0.8):
            self.train_steps = train_steps

    def update_downscale(self, elapsed_ms: float):
        full_render_ms = elapsed_ms * self.downscale ** 2
        downscale = min(8, max(1, int(np.sqrt(
            full_render_ms / self.target_render_ms))))
        if downscale != self.downscale:
            self.downscale = downscale


class HeadlessViewer:
    """The viewer's loop without a window (module docstring)."""

    def __init__(self, cfg: Config, session: InteractiveSession,
                 trainer=None, train_dataset=None):
        self.cfg = cfg
        self.session = session
        self.trainer = trainer
        self.train_dataset = train_dataset
        self.camera = OrbitCamera(session.W, session.H, r=2.0, fovy=60.0)
        self.ctrl = AdaptiveController()
        self.training = trainer is not None and train_dataset is not None
        self.fps = 0.0
        b = float(session.model.render_cfg.grid_bound)
        self.aabb = np.asarray([-b, -b, -b, b, b, b], np.float32)
        self.bg_color = 1.0
        self.mode = "image"  # 'image' | 'depth'
        self.max_spp = int(getattr(cfg, "max_spp", 1) or 1)
        self.spp = 0
        self._need_update = True
        self._last_result = None

    def mark_dirty(self):
        """The camera or the state changed: accumulation restarts."""
        self._need_update = True
        self.spp = 0

    def start_training(self):
        self.training = (self.trainer is not None
                         and self.train_dataset is not None)

    def stop_training(self):
        self.training = False

    def save_checkpoint(self):
        if self.trainer is not None:
            self.trainer.save_checkpoint(full=True)

    def frame(self, click=None):
        t0 = time.time()
        # nothing changed and max_spp reached: the last frame stands
        if (not self._need_update and not self.training and click is None
                and 1 < self.max_spp <= self.spp
                and self._last_result is not None):
            return self._last_result
        if self.training:
            tt0 = time.time()
            for _ in range(self.ctrl.train_steps):
                self.trainer.train_step(self.train_dataset,
                                        self.cfg.train.num_rays)
            self.ctrl.update_train_steps((time.time() - tt0) * 1e3)
            self.session.params = self.trainer.eval_params()
        # a static camera averages jittered renders up to max_spp (the
        # running mean lives on the device); a fresh seed per sample
        accumulate = (not self._need_update and not self.training
                      and click is None and self.max_spp > 1
                      and self.spp < self.max_spp)
        generator, spp = None, 0
        if accumulate and self.spp > 0:
            generator = torch.Generator(
                device=self.session.device).manual_seed(self.spp)
            spp = self.spp
        result = self.session.step(
            self.camera.pose, self.camera.intrinsics, click=click,
            downscale=self.ctrl.downscale, aabb=self.aabb,
            bg_color=self.bg_color, mode=self.mode, generator=generator,
            spp=spp)
        if self.max_spp > 1:
            self.spp = self.spp + 1 if accumulate else 1
        self._need_update = False
        self._last_result = result
        dt_ms = (time.time() - t0) * 1e3
        self.ctrl.update_downscale(dt_ms)
        self.fps = 1000.0 / max(dt_ms, 1e-3)
        return result

    def orbit(self, dx, dy):
        self.camera.orbit(dx, dy)
        self.mark_dirty()

    def zoom(self, delta):
        self.camera.scale(delta)
        self.mark_dirty()

    def pan(self, dx, dy):
        self.camera.pan(dx, dy)
        self.mark_dirty()

    def right_click(self, x, y):
        """Adds or removes a segmentation point at the pixel."""
        return self.frame(click=(x, y))


def launch_gui(cfg: Config, trainer, sam_predictor=None, train_dataset=None):
    """The dearpygui window where dearpygui imports, else 10 headless
    frames orbiting 30 px apart, written as PNGs -> the viewer."""
    session = InteractiveSession(cfg, trainer.model, trainer.eval_params(),
                                 sam_predictor, H=512, W=512,
                                 device=trainer.device)
    try:
        import dearpygui.dearpygui as dpg  # noqa: F401

        return _run_dearpygui(cfg, session, trainer, train_dataset)
    except ImportError:
        print("[WARN] dearpygui unavailable; running headless viewer "
              "(10 frames)")
        viewer = HeadlessViewer(cfg, session,
                                trainer if train_dataset else None,
                                train_dataset)
        out_dir = os.path.join(cfg.workspace, "gui_frames")
        os.makedirs(out_dir, exist_ok=True)
        for i in range(10):
            viewer.orbit(30, 0)
            res = viewer.frame()
            save_png(os.path.join(out_dir, f"frame_{i:03d}.png"), res.rgb_u8)
        print(f"[INFO] headless frames written to {out_dir}; "
              f"fps~{viewer.fps:.1f}")
        return viewer


def _run_dearpygui(cfg: Config, session: InteractiveSession, trainer,
                   train_dataset):
    """The windowed loop: a texture window, a control panel (fovy, mode,
    background, AABB, training and checkpoint buttons) and the mouse
    handlers (orbit, pan, zoom, right-click prompt)."""
    import dearpygui.dearpygui as dpg

    viewer = HeadlessViewer(cfg, session, trainer if train_dataset else None,
                            train_dataset)
    W, H = session.W, session.H
    buffer = np.ones((H, W, 3), np.float32)

    dpg.create_context()
    with dpg.texture_registry():
        dpg.add_raw_texture(W, H, buffer.ravel(),
                            format=dpg.mvFormat_Float_rgb, tag="_texture")
    with dpg.window(tag="_primary", width=W, height=H):
        dpg.add_image("_texture")

    def set_fovy(s, v):
        viewer.camera.fovy = v
        viewer.mark_dirty()

    def set_mode(s, v):
        viewer.mode = v
        viewer.mark_dirty()

    def set_bg(s, v):
        viewer.bg_color = float(np.mean(v[:3]))
        viewer.mark_dirty()

    def set_aabb(axis):
        def cb(s, v):
            viewer.aabb[axis] = v
            viewer.mark_dirty()
        return cb

    b = float(session.model.render_cfg.grid_bound)
    with dpg.window(label="Control", width=320, height=H, pos=(W, 0)):
        dpg.add_text("", tag="_fps")
        dpg.add_slider_float(label="fovy", default_value=60, min_value=30,
                             max_value=120, callback=set_fovy)
        dpg.add_radio_button(("image", "depth"), default_value="image",
                             horizontal=True, callback=set_mode)
        dpg.add_color_edit((255, 255, 255), label="bg color",
                           no_alpha=True, callback=set_bg)
        with dpg.collapsing_header(label="AABB", default_open=False):
            for i, name in enumerate(("xmin", "ymin", "zmin",
                                      "xmax", "ymax", "zmax")):
                dpg.add_slider_float(label=name, min_value=-b, max_value=b,
                                     default_value=float(viewer.aabb[i]),
                                     callback=set_aabb(i))
        if trainer is not None and train_dataset is not None:
            with dpg.group(horizontal=True):
                dpg.add_button(label="start train",
                               callback=lambda: viewer.start_training())
                dpg.add_button(label="stop train",
                               callback=lambda: viewer.stop_training())
                dpg.add_button(label="save ckpt",
                               callback=lambda: viewer.save_checkpoint())

    def on_drag(sender, app_data):
        if dpg.is_item_focused("_primary"):
            viewer.orbit(app_data[1], app_data[2])

    def on_pan(sender, app_data):
        if dpg.is_item_focused("_primary"):
            viewer.pan(app_data[1], app_data[2])

    def on_wheel(sender, app_data):
        viewer.zoom(app_data)

    def on_right_click(sender, app_data):
        x, y = dpg.get_mouse_pos()
        viewer.right_click(x, y)

    with dpg.handler_registry():
        dpg.add_mouse_drag_handler(button=dpg.mvMouseButton_Left,
                                   callback=on_drag)
        dpg.add_mouse_drag_handler(button=dpg.mvMouseButton_Middle,
                                   callback=on_pan)
        dpg.add_mouse_wheel_handler(callback=on_wheel)
        dpg.add_mouse_click_handler(button=dpg.mvMouseButton_Right,
                                    callback=on_right_click)

    dpg.create_viewport(title="sanerf_tpu_torch", width=W + 300, height=H)
    dpg.setup_dearpygui()
    dpg.show_viewport()
    while dpg.is_dearpygui_running():
        res = viewer.frame()
        buffer[:] = np.clip(res.composed, 0, 1)
        dpg.set_value("_texture", buffer.ravel())
        dpg.set_value("_fps", f"{viewer.fps:.1f} FPS | downscale "
                      f"{viewer.ctrl.downscale} | spp {viewer.spp}")
        dpg.render_dearpygui_frame()
    dpg.destroy_context()
    return viewer
