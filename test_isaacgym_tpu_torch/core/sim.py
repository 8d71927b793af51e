"""Native Simulator: Scene + Stepper + state tensors.

Port of test_isaacgym_tpu/core/sim.py for scenes of free and static bodies.
Replaces the reference's Sim handle + tensor API (`prepare_sim` /
`acquire_*` / `refresh_*` / `set_*`): state is an attribute, acquire is
attribute access, refresh happens inside step. The Jacobian and mass-matrix
functions come with the articulated slice of the port.
"""
from __future__ import annotations

import torch

from ..physics.step import Stepper
from .scene import Scene
from .state import PhysParams, SimState, zero_actions


def _to(value, device):
    """A NamedTuple of tensors with every tensor on `device`."""
    return type(value)(*[None if v is None else v.to(device) for v in value])


class Simulator:
    def __init__(self, scene: Scene, state: SimState, params: PhysParams, device="cuda"):
        self.device = torch.device(device)
        self.scene = scene
        self.stepper = Stepper(scene, self.device)
        self.env_origins = torch.as_tensor(
            scene.env_origins, dtype=torch.float32, device=self.device
        )
        self.params = _to(params, self.device)
        self.state = self.stepper.refresh_body_state(_to(state, self.device), self.params)
        self.initial_state = self.state
        self.actions = zero_actions(
            scene.num_envs,
            scene.num_dofs_per_env,
            scene.num_bodies_per_env,
            num_attractors=len(scene.attractors),
            device=self.device,
        )

    # -- stepping -----------------------------------------------------------
    def step(self):
        self.state = self.stepper.step(self.state, self.actions, self.params)

    def rollout(self, num_steps: int):
        self.state = self.stepper.rollout(self.state, self.actions, self.params, num_steps)

    def reset(self, env_mask=None):
        """Snapshot-restore (the reference's get/set_sim_rigid_body_states
        checkpoint path), optionally per env."""
        if env_mask is None:
            self.state = self.initial_state
            return
        m = torch.as_tensor(env_mask, dtype=torch.bool, device=self.device)

        def sel(new, old):
            if new is None or new.dim() == 0:
                return old
            return torch.where(m.reshape(m.shape + (1,) * (new.dim() - 1)), new, old)

        self.state = SimState(*[sel(n, o) for n, o in zip(self.initial_state, self.state)])

    # -- tensor API equivalents --------------------------------------------
    @property
    def root_state(self):
        """Env-local (IsaacGym tensor semantics)."""
        return self.state.root_state_tensor(self.env_origins)

    @root_state.setter
    def root_state(self, tensor):
        t = torch.as_tensor(tensor, dtype=torch.float32, device=self.device)
        self.state = self.state.with_root_state_tensor(t, self.env_origins)
        self.state = self.stepper.refresh_body_state(self.state, self.params)

    @property
    def body_state(self):
        """Env-local (IsaacGym tensor semantics)."""
        return self.state.body_state_tensor(self.env_origins)

    @property
    def net_contact_force(self):
        n, b = self.state.contact_force.shape[:2]
        return self.state.contact_force.reshape(n * b, 3)

    def apply_body_forces(self, forces=None, torques=None, positions=None):
        a = self.actions
        shape = (self.scene.num_envs, self.scene.num_bodies_per_env, 3)

        def t(x):
            return torch.as_tensor(x, dtype=torch.float32, device=self.device).reshape(shape)

        if forces is not None:
            a = a._replace(body_force=t(forces))
        if torques is not None:
            a = a._replace(body_torque=t(torques))
        if positions is not None:
            a = a._replace(
                body_force_pos=t(positions),
                use_force_pos=torch.ones((), dtype=torch.bool, device=self.device),
            )
        self.actions = a


def make_sim(builder, device="cuda") -> Simulator:
    scene, state, params = builder.finalize(device)
    return Simulator(scene, state, params, device=device)
