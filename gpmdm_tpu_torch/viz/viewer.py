"""Interactive 3D skeleton animation player (pygame + OpenGL).

Counterpart of the reference ``Viewer``
(`reference/amc_parser/viewer.py:13`): play/pause, frame stepping,
camera rotate / translate / zoom.  Redesigned around the batched-FK position
array — all frames are precomputed once; the render loop only draws.

Controls:
  space        play / pause
  left/right   step one frame (when paused)
  up/down      playback speed
  w/s/a/d      translate camera
  q/e          zoom
  mouse drag   rotate camera
  r            reset camera
  escape       quit

A copy of ``gpmdm_tpu/viz/viewer.py`` for the port, on its numpy FK;
pygame and OpenGL are imported inside the methods that need them.
"""

from __future__ import annotations

import numpy as np

from ..data.amc_asf import Motion, Skeleton
from ..data.fk import forward_kinematics


class Viewer:
    def __init__(self, skeleton: Skeleton, motion: Motion, fps: int = 120):
        self.skeleton = skeleton
        self.motion = motion
        self.fps = fps
        self.positions = forward_kinematics(skeleton, motion)["positions"]
        self.frame = 0
        self.playing = True
        self.speed = 1.0
        self.rot = np.array([20.0, -30.0])  # pitch, yaw degrees
        self.trans = np.array([0.0, -1.0, -6.0])
        self._dragging = False

    # ------------------------------------------------------- event handling

    def process_event(self, ev) -> bool:
        """Handle one pygame event; returns False when the viewer should
        quit (reference process_event, amc_parser/viewer.py:91).  GL-free,
        so the whole control surface is unit-testable without a display."""
        import pygame
        from pygame.locals import (
            K_DOWN, K_ESCAPE, K_LEFT, K_RIGHT, K_SPACE, K_UP,
            K_a, K_d, K_e, K_q, K_r, K_s, K_w, KEYDOWN, MOUSEBUTTONDOWN,
            MOUSEBUTTONUP, MOUSEMOTION, QUIT,
        )

        if ev.type == QUIT:
            return False
        if ev.type == KEYDOWN:
            if ev.key == K_ESCAPE:
                return False
            elif ev.key == K_SPACE:
                self.playing = not self.playing
            elif ev.key == K_RIGHT:
                self.frame = (self.frame + 1) % len(self.positions)
            elif ev.key == K_LEFT:
                self.frame = (self.frame - 1) % len(self.positions)
            elif ev.key == K_UP:
                self.speed = min(self.speed * 1.5, 8.0)
            elif ev.key == K_DOWN:
                self.speed = max(self.speed / 1.5, 0.125)
            elif ev.key == K_w:
                self.trans[1] -= 0.2
            elif ev.key == K_s:
                self.trans[1] += 0.2
            elif ev.key == K_a:
                self.trans[0] += 0.2
            elif ev.key == K_d:
                self.trans[0] -= 0.2
            elif ev.key == K_q:
                self.trans[2] += 0.4
            elif ev.key == K_e:
                self.trans[2] -= 0.4
            elif ev.key == K_r:
                self.rot[:] = (20.0, -30.0)
                self.trans[:] = (0.0, -1.0, -6.0)
        elif ev.type == MOUSEBUTTONDOWN and ev.button == 1:
            self._dragging = True
        elif ev.type == MOUSEBUTTONUP and ev.button == 1:
            self._dragging = False
        elif ev.type == MOUSEMOTION and self._dragging:
            self.rot[1] += ev.rel[0] * 0.3
            self.rot[0] += ev.rel[1] * 0.3
        return True

    def step(self) -> None:
        """Advance playback by the current speed (no-op when paused)."""
        if self.playing:
            self.frame = (self.frame + max(1, int(self.speed))) % len(self.positions)

    # ------------------------------------------------------------------ loop

    def run(self) -> None:
        import pygame
        from OpenGL import GL, GLU
        from pygame.locals import DOUBLEBUF, OPENGL

        pygame.init()
        size = (1024, 768)
        pygame.display.set_mode(size, DOUBLEBUF | OPENGL)
        pygame.display.set_caption("gpmdm_tpu_torch viewer")
        # Set the projection on the PROJECTION stack: _draw_frame's
        # per-frame glLoadIdentity() resets the modelview stack, so a
        # perspective left on the (default) modelview matrix would be
        # erased before the first frame and everything would clip out.
        GL.glMatrixMode(GL.GL_PROJECTION)
        GL.glLoadIdentity()
        GLU.gluPerspective(45, size[0] / size[1], 0.1, 100.0)
        GL.glMatrixMode(GL.GL_MODELVIEW)
        GL.glEnable(GL.GL_DEPTH_TEST)
        GL.glPointSize(6.0)

        clock = pygame.time.Clock()
        running = True
        while running:
            for ev in pygame.event.get():
                if not self.process_event(ev):
                    running = False
            self.step()
            self._draw_frame(GL)
            pygame.display.flip()
            clock.tick(self.fps)
        pygame.quit()

    def _draw_frame(self, GL) -> None:
        """Draw one frame's joints + bones.  Projection is set once in
        run(); this only touches the modelview stack, and takes the GL
        module as a parameter so tests can drive it with a recording stub
        (no GL context exists headless)."""
        GL.glClear(GL.GL_COLOR_BUFFER_BIT | GL.GL_DEPTH_BUFFER_BIT)
        GL.glLoadIdentity()
        GL.glTranslatef(*self.trans)
        GL.glRotatef(self.rot[0], 1, 0, 0)
        GL.glRotatef(self.rot[1], 0, 1, 0)

        pos = self.positions[self.frame]
        GL.glColor3f(0.2, 0.5, 1.0)
        GL.glBegin(GL.GL_POINTS)
        for p in pos:
            GL.glVertex3f(p[0], p[1], p[2])
        GL.glEnd()
        GL.glColor3f(1.0, 0.3, 0.3)
        GL.glBegin(GL.GL_LINES)
        for j, parent in enumerate(self.skeleton.parent):
            if parent < 0:
                continue
            GL.glVertex3f(*pos[j])
            GL.glVertex3f(*pos[int(parent)])
        GL.glEnd()
