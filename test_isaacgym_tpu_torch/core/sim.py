"""Native Simulator: Scene + Stepper + state tensors.

Port of test_isaacgym_tpu/core/sim.py. Replaces the reference's Sim handle +
tensor API (`prepare_sim` / `acquire_*` / `refresh_*` / `set_*`): state is an
attribute, acquire is attribute access, refresh happens inside step. The
Jacobian and mass-matrix functions are plain functions of a state.
"""
from __future__ import annotations

import torch

from ..physics import dynamics
from ..physics.kinematics import body_jacobian, fk, jacobian as link_jacobian
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
        state = _to(state, self.device)
        # size the persistent warm-start impulse rows to the contact table
        # (opt-in: physx.warm_start_contacts)
        C = self.stepper.contact.num_contacts
        if C and scene.sim_params.physx.warm_start_contacts:
            n = state.root_pos.shape[0]
            state = state._replace(
                warm_n=torch.zeros((n, C), dtype=torch.float32, device=self.device),
                warm_t=torch.zeros((n, C, 3), dtype=torch.float32, device=self.device),
            )
        self.state = self.stepper.refresh_body_state(state, self.params)
        self.initial_state = self.state
        self.actions = zero_actions(
            scene.num_envs,
            scene.num_dofs_per_env,
            scene.num_bodies_per_env,
            num_attractors=len(scene.attractors),
            device=self.device,
        )
        if scene.attractors:
            # every attractor on, aimed at its initial target
            ai = scene.attractor_init
            self.actions = self.actions._replace(
                attractor_target_pos=self._tensor(ai["target_pos"]),
                attractor_target_quat=self._tensor(ai["target_quat"]),
                attractor_enabled=torch.ones(
                    ai["stiffness"].shape, dtype=torch.bool, device=self.device
                ),
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
    def _tensor(self, x):
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    @property
    def root_state(self):
        """Env-local (IsaacGym tensor semantics)."""
        return self.state.root_state_tensor(self.env_origins)

    @root_state.setter
    def root_state(self, tensor):
        self.state = self.state.with_root_state_tensor(self._tensor(tensor), self.env_origins)
        self.state = self.stepper.refresh_body_state(self.state, self.params)

    @property
    def dof_state(self):
        return self.state.dof_state_tensor()

    @dof_state.setter
    def dof_state(self, tensor):
        self.state = self.state.with_dof_state_tensor(self._tensor(tensor))
        self.state = self.stepper.refresh_body_state(self.state, self.params)

    @property
    def body_state(self):
        """Env-local (IsaacGym tensor semantics)."""
        return self.state.body_state_tensor(self.env_origins)

    @property
    def net_contact_force(self):
        n, b = self.state.contact_force.shape[:2]
        return self.state.contact_force.reshape(n * b, 3)

    def _per_dof(self, x):
        return self._tensor(x).reshape(self.scene.num_envs, self.scene.num_dofs_per_env)

    def set_dof_position_targets(self, targets):
        self.actions = self.actions._replace(dof_pos_target=self._per_dof(targets))

    def set_dof_velocity_targets(self, targets):
        self.actions = self.actions._replace(dof_vel_target=self._per_dof(targets))

    def set_dof_actuation_forces(self, efforts):
        self.actions = self.actions._replace(dof_effort=self._per_dof(efforts))

    def apply_body_forces(self, forces=None, torques=None, positions=None):
        a = self.actions
        shape = (self.scene.num_envs, self.scene.num_bodies_per_env, 3)

        def t(x):
            return self._tensor(x).reshape(shape)

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

    # -- jacobian / mass matrix --------------------------------------------
    def _group_of_actor(self, actor_name: str):
        meta = self.scene.find_actor(actor_name)
        for gi, g in enumerate(self.scene.art_groups):
            if meta.slot in g.slots:
                return self.stepper.groups[gi], g, meta
        raise KeyError(f"{actor_name} is not an articulated actor")

    def _link_pose_fn(self, gi, copy, slot):
        """state -> (pos, quat) of every sim link for one actor copy.
        Reuses the always-fresh body-state cache when all links are real
        bodies (no FK re-sweep); falls back to FK otherwise."""
        if gi.all_real:
            idx = gi.link_body_idx[copy]

            def fn(state: SimState):
                return state.body_pos[:, idx], state.body_quat[:, idx]

            return fn
        topo = gi.topo
        didx = gi.dof_idx[copy]

        def fn(state: SimState):
            pos, quat, _, _ = fk(
                topo,
                state.root_pos[:, slot],
                state.root_quat[:, slot],
                state.root_linvel[:, slot],
                state.root_angvel[:, slot],
                state.dof_pos[:, didx],
                state.dof_vel[:, didx],
            )
            return pos, quat

        return fn

    def jacobian_fn(self, actor_name: str):
        """Returns a function state -> jacobian tensor with IsaacGym layout:
        fixed base: (N, num_bodies-1, 6, D); floating: (N, num_bodies, 6, 6+D).
        Rows are [linear(3); angular(3)] of each body origin."""
        gi, g, meta = self._group_of_actor(actor_name)
        topo = gi.topo
        copy = list(g.slots).index(meta.slot)
        pose = self._link_pose_fn(gi, copy, meta.slot)
        # real links, without the base row for a fixed base (reference indexing)
        real = gi.real_links[1:] if topo.fixed_base else gi.real_links

        def fn(state: SimState):
            pos, quat = pose(state)
            return link_jacobian(topo, pos, quat)[:, real]  # (N, B, 6, nv)

        return fn

    def body_jacobian_fn(self, actor_name: str, body_name: str):
        """Function state -> (N, 6, nv) jacobian of one named body — the
        hot-loop variant (full-tensor jacobian_fn matches the reference layout)."""
        gi, g, meta = self._group_of_actor(actor_name)
        topo = gi.topo
        copy = list(g.slots).index(meta.slot)
        body_idx = meta.asset.rigid_body_dict()[body_name]
        link = [int(l) for l, b in enumerate(topo.body_of_link) if b == body_idx][0]
        pose = self._link_pose_fn(gi, copy, meta.slot)

        def fn(state: SimState):
            pos, quat = pose(state)
            return body_jacobian(topo, pos, quat, link)

        return fn

    def mass_matrix_fn(self, actor_name: str):
        """Function (state[, params]) -> (N, D, D) joint-space mass matrix
        (fixed-base layout of acquire_mass_matrix_tensor).

        Consumes the RUNTIME body params (mass/com/inertia), so the exposed
        tensor agrees with the dynamics after domain randomization — the same
        gather physics/step.py does. `params` defaults to the simulator's
        current params."""
        gi, g, meta = self._group_of_actor(actor_name)
        topo = gi.topo
        copy = list(g.slots).index(meta.slot)
        base = 0 if topo.fixed_base else 6
        pose = self._link_pose_fn(gi, copy, meta.slot)
        lbidx = gi.link_body_idx[copy]  # (Ls,) env body index
        is_real = gi.link_is_real

        def fn(state: SimState, params=None):
            p = params if params is not None else self.params
            pos, quat = pose(state)
            mass_l, com_l, inert_l = p.body_mass[:, lbidx], p.body_com[:, lbidx], p.body_inertia[:, lbidx]
            if not gi.all_real:
                mass_l = torch.where(is_real, mass_l, topo.mass)
                com_l = torch.where(is_real[..., None], com_l, topo.com)
                inert_l = torch.where(is_real[..., None, None], inert_l, topo.inertia)
            M = dynamics.mass_matrix(topo, pos, quat, mass=mass_l, com=com_l, inertia=inert_l)
            return M[..., base:, base:]

        return fn

    def jacobian(self, actor_name: str):
        return self.jacobian_fn(actor_name)(self.state)

    def mass_matrix(self, actor_name: str):
        return self.mass_matrix_fn(actor_name)(self.state)


def make_sim(builder, device="cuda") -> Simulator:
    scene, state, params = builder.finalize(device)
    return Simulator(scene, state, params, device=device)
