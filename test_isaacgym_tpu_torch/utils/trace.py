"""Spans of the step and timed set-up stages, for a profiler to read.

`span(name)` names a stretch of host work to a running torch profiler:
inside `torch.profiler.profile` it is `torch.profiler.record_function(name)`,
whose events (chrome-trace category `user_annotation`) lie on the profiler's
clock, beside the launch calls and the device's kernels and copies. With no
profiler running it returns one shared null context and does nothing else:
the test is the flag the profiler itself sets on entry.

`stage(name)` times once-per-process set-up work on the host clock: it adds
the seconds of its body to `stage_s[name]` on every call, and under a
profiler it is a span as well.

Spans, nested as the calls are:
  sim.step                 physics/step.py Stepper.step: the whole step,
                           substeps, soft solve and refresh
    sim.phase_a            Stepper._substep's group_velocities: drives, FK
                           where the body state is not reused, forward
                           dynamics, joint friction, attractors
    sim.phase_b            free_velocities: the free bodies' velocities
    sim.phase_c            contact_inputs and ContactSolver.solve: the whole
                           contact phase
      contact.sphere_world ContactSolver.solve's sphere world: its inputs,
                           ops/sphere_world.solve (two launches on the card)
                           and the scatter of its results
    sim.phase_d            integrate: joint limits and position integration
    sim.soft               the XPBD soft solve after each rigid substep
                           (physics/soft.py SoftStepper.substep): 3 a step
                           with 3 substeps
      soft.iterations      SoftStepper.substep's iterations (flex outer x
                           inner): the launch of csrc/xpbd.cu on the card,
                           which does the prediction, friction and damping
                           too; the loop between them on the CPU
    sim.refresh            Stepper.refresh_body_state: the body-cache refresh
  fk                       physics/kinematics.py fk, wherever it is called
  crba                     physics/dynamics.py crba: the mass matrix
  rnea                     physics/dynamics.py rnea_bias: the bias force
  chol                     utils/linalg.py spd_solve and spd_inv: the
                           launch of csrc/chol.cu on the card, the
                           unrolled Cholesky solves on the CPU
  control.osc              envs/franka.py FrankaOscEnv._control: the OSC law
    control.osc.jacobian   its hand Jacobian
    control.osc.mass_matrix  its runtime mass matrix
  render                   render/raster.py render_camera_batch, whole: a
                           frame of every env's camera
    render.rays            camera_rays: the pixels' world ray directions; on
                           csrc/raycast.cu's route, the focal lengths and
                           forward axes alone
    render.primitives      render_rays' block loop of _primitive_block: the
                           ray-shape tests, the ground, the shading; on the
                           kernel's route, its launch, which also packs
    render.pack            depth, optical flow when asked for, the reshapes,
                           supersampling and the uint8 colour (the plain
                           route only)
  render.poses             render/raster.py shape_world_poses: every shape's
                           world pose (called before render_camera_batch)

Stages:
  setup.build              core/scene.py SceneBuilder.create_env and
                           create_actor, summed over every call
  setup.finalize           SceneBuilder.finalize and core/sim.py
                           Simulator.__init__ (the Stepper, the contact
                           tables, the device tensors)
    setup.soft             inside setup.finalize: physics/soft.py
                           build_soft_world (from SceneBuilder.finalize;
                           microseconds in a scene without `<fem>` links)
                           and SoftStepper.__init__ (from the Stepper's),
                           both host loops over tets
  setup.render             render/raster.py tables_from_scene: the render
                           tables, and their copy to the device when asked
"""
from __future__ import annotations

import contextlib
import time

from torch.autograd import profiler as _profiler

stage_s: dict = {}  # stage name -> host seconds, summed over the process
_OFF = contextlib.nullcontext()


def span(name: str):
    """`record_function(name)` while a torch profiler runs, else a shared
    null context."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _profiler.record_function(name)


@contextlib.contextmanager
def stage(name: str):
    """Adds the host seconds of the body to stage_s[name]; a span too."""
    t = time.perf_counter()
    try:
        with span(name):
            yield
    finally:
        stage_s[name] = stage_s.get(name, 0.0) + time.perf_counter() - t
