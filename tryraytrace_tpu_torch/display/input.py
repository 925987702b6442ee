"""Input handling: interactive (SDL via pygame when available) and
headless scripted sources (a copy of tryraytrace_tpu/display/input.py).

Parity target: InputManager / InputState (reference input.h:5-22,
input.cpp:43-110): per-frame event poll producing {quit, save_request,
camera_moved}; WASD read as key-state snapshots, Esc quits, P saves,
Tab toggles mouse lock, click re-locks.

The reference hard-requires SDL2; here the interactive frontend is
optional (pygame, if importable) and a ``ScriptedInput`` drives the
same code paths headlessly for CI and benchmark fly-throughs.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator


@dataclasses.dataclass
class InputState:
    quit: bool = False
    save_request: bool = False
    camera_moved: bool = False


class ScriptedInput:
    """Headless input source: a sequence of per-frame event dicts.

    Each entry may contain ``keys`` (set of key names fed to
    CameraController.update), ``mouse`` ((xrel, yrel)), ``save`` and
    ``quit``.  When the script is exhausted, quit is signaled --
    deterministic camera paths for tests and the fly-through bench.
    """

    def __init__(self, script: list[dict]):
        self._it: Iterator[dict] = iter(script)

    def process_events(self, cam) -> InputState:
        state = InputState()
        try:
            ev = next(self._it)
        except StopIteration:
            state.quit = True
            return state
        if ev.get("mouse"):
            xr, yr = ev["mouse"]
            state.camera_moved |= cam.process_mouse(xr, yr)
        if ev.get("keys"):
            state.camera_moved |= cam.update(1.0, set(ev["keys"]))
        state.save_request = bool(ev.get("save"))
        state.quit = bool(ev.get("quit"))
        return state


class InputManager:
    """Interactive input via pygame (optional dependency).

    Key bindings mirror input.cpp:52-107: Esc quit, P save, Tab mouse
    lock toggle, click re-lock; WASDQE/RFTG sampled as key state each
    frame and fed to CameraController.update.
    """

    def __init__(self):
        import pygame  # noqa: deferred; raises if unavailable

        self._pg = pygame
        self.mouse_locked = True
        pygame.event.set_grab(True)
        pygame.mouse.set_visible(False)

    def process_events(self, cam) -> InputState:
        pg = self._pg
        state = InputState()
        for ev in pg.event.get():
            if ev.type == pg.QUIT:
                state.quit = True
            elif ev.type == pg.KEYDOWN:
                if ev.key == pg.K_ESCAPE:
                    state.quit = True
                elif ev.key == pg.K_p:
                    state.save_request = True
                elif ev.key == pg.K_TAB:
                    self.mouse_locked = not self.mouse_locked
                    pg.event.set_grab(self.mouse_locked)
                    pg.mouse.set_visible(not self.mouse_locked)
            elif ev.type == pg.MOUSEBUTTONDOWN and not self.mouse_locked:
                self.mouse_locked = True
                pg.event.set_grab(True)
                pg.mouse.set_visible(False)
            elif ev.type == pg.MOUSEMOTION and self.mouse_locked:
                state.camera_moved |= cam.process_mouse(*ev.rel)

        pressed = pg.key.get_pressed()
        keys = set()
        for name in "wasdqerftg":
            if pressed[getattr(pg, f"K_{name}")]:
                keys.add(name)
        if keys:
            state.camera_moved |= cam.update(1.0, keys)
        return state
