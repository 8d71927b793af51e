"""Driver of the configuration franka-4096: the Panda stand-in at 4,096
envs on one card tracking FrankaOscEnv's circle under OSC (traffic
"track"): the port's `envs/franka.py::FrankaOscEnv` on the program's side,
reference/franka.py on the reference's and the control's."""
import os

import numpy as np
import torch

from portbench.harness import sides
from portbench.harness.cell import Cell
from portbench.harness.opcount import count_ops
from portbench.harness.spec import ROOT
from portbench.reference import franka as ref


def generator(device, seed: int, rank: int = 0) -> torch.Generator:
    """A generator on `device` seeded by (seed, rank)."""
    state = np.random.SeedSequence([seed % 2**63, rank]).generate_state(2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed(int(state[0]) << 31 | int(state[1]) >> 1)
    return g


def inputs(cfg, traffic, seed, device, rank=0):
    """Each env's arm joints offset from the default pose, uniform in
    +-dof_offset rad."""
    a = traffic["dof_offset"]
    u = torch.rand((cfg["num_envs"], cfg["arm_dofs"]), generator=generator(device, seed, rank),
                   device=device)
    return {"dof_offset": u * (2 * a) - a}


def _program(cfg, inputs, device) -> Cell:
    """FrankaOscEnv from the perturbed start, no resets; the step is
    `rollout_fn(1)`, its output the OSC effort (read from `_control`)."""
    env = sides.port("envs.franka").FrankaOscEnv(
        num_envs=cfg["num_envs"], kp=cfg["kp"], kv=cfg["kv"],
        asset_root=os.path.join(ROOT, cfg["asset_root"]), device=device)
    sim, arm = env.sim, cfg["arm_dofs"]
    q = sim.state.dof_pos.clone()
    q[:, :arm] += inputs["dof_offset"]
    start = sim.stepper.refresh_body_state(sim.state._replace(dof_pos=q), sim.params)
    control, stash = env._control, {}

    def stashing(*a, **k):
        out = control(*a, **k)
        stash["effort"] = out[0]
        return out

    env._control = stashing

    def step(state):
        return env.rollout_fn(1)(state), (stash["effort"],)

    hand = env.hand_body

    def fields(state, out):
        f = {"dof_pos": state.dof_pos, "dof_vel": state.dof_vel,
             "hand_pos": state.body_pos[:, hand] - env.origins,
             "hand_quat": state.body_quat[:, hand]}
        if out is not None:
            f["effort"] = out[0]
        return f

    return Cell(
        envs=cfg["num_envs"], starts=[start], step=step, fields=fields,
        handoff=lambda s: ref.State(s.dof_pos, s.dof_vel, s.steps),
        spans=[(env, "_control", "control"), (sim.stepper, "step", "simulator")],
        counts=lambda s: {"control.ops": count_ops(lambda: control(s, s.steps, params=sim.params))},
    )


def _reference(cfg, inputs, device) -> Cell:
    arm = ref.FrankaTrack(cfg, os.path.join(ROOT, cfg["asset_root"], cfg["urdf"]), device)
    return Cell(envs=cfg["num_envs"], starts=[arm.start(inputs["dof_offset"])], step=arm.step,
                fields=arm.fields)


def build(cfg, traffic, inputs, device, impl="program", rank=0, world=1):
    if impl == "program":
        return _program(cfg, inputs, device)
    return sides.reference_cell(_reference(cfg, inputs, device), impl)


def reference(cfg, traffic, inputs, device, rank=0, world=1):
    return _reference(cfg, inputs, device)
