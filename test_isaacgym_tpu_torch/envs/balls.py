"""Balls-of-solitude world: the contact-scale benchmark env.

Port of test_isaacgym_tpu/envs/balls.py. Mirrors the reference's
examples/1080_balls_of_solitude.py under --all_collisions: 36 four-layer ball
pyramids (30 balls each = 1080 balls) share ONE collision world (collision
group 0 everywhere), fall under gravity, bounce, and spread into piles. This
is the workload the dense sphere-world contact path (ops/sphere_world.py)
exists for — a single env holds all 1080 free bodies, so every candidate
pair is live.

`num_worlds` batches identical worlds along the env axis. With `heightfield`
the world lies over terrain instead of the ground plane (the reference's
examples/terrain_creation.py drops its balls so): the sphere world then
solves the ball pairs without a ground, and each ball's terrain contact is
a row of the contact table.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..assets.primitives import create_sphere
from ..core.config import PlaneParams, SimParams
from ..core.scene import SceneBuilder
from ..core.sim import Simulator
from ..core.state import SimState


def pyramid_positions(pyramids: int, base: int = 4, radius: float = 0.2,
                      seed: int = 17) -> np.ndarray:
    """(n, 3) ball centres of `pyramids` pyramids of `base` x `base` layers
    on a grid of 2.5 m cells (the reference's env_spacing 1.25), each
    jittered by RandomState(seed), balls 2.5 radii apart (reference :107),
    the lowest layer at 1.5 m."""
    rng = np.random.RandomState(seed)
    spacing = 2.5 * radius
    grid = int(np.ceil(np.sqrt(pyramids)))
    cell = 2.5
    jitter = rng.uniform(-0.01, 0.01, (pyramids, 2))
    out = []
    for p in range(pyramids):
        cx = (p % grid - (grid - 1) / 2) * cell + jitter[p, 0]
        cy = (p // grid - (grid - 1) / 2) * cell + jitter[p, 1]
        n, z = base, 1.5
        while n > 0:
            m = -0.5 * (n - 1) * spacing
            for i in range(n):
                for j in range(n):
                    out.append((cx + m + i * spacing, cy + m + j * spacing, z))
            z += spacing
            n -= 1
    return np.array(out)


@dataclasses.dataclass
class BallsEnv:
    num_worlds: int = 1
    pyramids: int = 36  # 6 x 6 grid of pyramids (reference: 36 envs)
    base: int = 4  # pyramid base -> 16+9+4+1 = 30 balls each
    radius: float = 0.2
    seed: int = 17  # reference seeds 17 (:91)
    device: str = "cuda"
    # terrain in place of the ground plane: SceneBuilder.add_heightfield's
    # (heightfield_raw, horizontal_scale, vertical_scale, offset_x, offset_y)
    heightfield: Optional[tuple] = None

    def __post_init__(self):
        sp = SimParams(dt=1 / 60, substeps=1, gravity=(0.0, 0.0, -9.8))
        sp.physx.num_position_iterations = 4  # reference :128-129
        sp.physx.num_velocity_iterations = 1
        ball = create_sphere(self.radius, density=500.0)

        b = SceneBuilder(sp)
        if self.heightfield is None:
            b.add_ground(PlaneParams())
        else:
            b.add_heightfield(*self.heightfield)
        centres = pyramid_positions(self.pyramids, self.base, self.radius, self.seed)
        for w in range(self.num_worlds):
            b.create_env((-8, -8, 0), (8, 8, 8), 1)
            for k, pos in enumerate(centres):
                b.create_actor(w, ball, pos=tuple(pos), name=f"ball{k}", group=0, filter=0)
        self.balls_per_world = len(centres)
        self.sim = Simulator(*b.finalize(self.device), device=self.device)

    # ------------------------------------------------------------------
    def rollout_fn(self, num_steps: int):
        """A callable (state) -> state running num_steps physics steps."""
        stepper = self.sim.stepper
        actions = self.sim.actions
        params = self.sim.params

        def run(state: SimState) -> SimState:
            return stepper.rollout(state, actions, params, num_steps)

        return run

    def ball_positions(self, state: SimState = None):
        state = state if state is not None else self.sim.state
        return state.root_pos
