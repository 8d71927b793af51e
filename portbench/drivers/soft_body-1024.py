"""Driver of the configuration soft_body-1024: examples/soft_body.py at
1,024 envs, a tet-mesh icosphere dropped under the press plate of its rail
(traffic "press"): the port's scene (`envs/soft_body.py::soft_body_sim`,
built by SceneBuilder and Simulator) stepped by `Stepper.rollout`, whose
every rigid substep is followed by `SoftStepper.substep`, on the program's
side; reference/soft_body.py on the reference's and the control's. Each
episode restarts from the set-up's snapshot; no actions (the rail's drive
holds its target 0). The per-env materials are drawn from the seed."""
import numpy as np
import torch

from portbench.harness import sides
from portbench.harness.cell import Cell
from portbench.harness.spec import ROOT
from portbench.reference import soft_body as ref


def inputs(cfg, traffic, seed, device, rank=0):
    """Each env's Young's modulus, Poisson's ratio (clipped) and damping,
    drawn as the example draws them (`example_materials`), from a seed made
    of (seed, rank)."""
    state = np.random.SeedSequence([seed % 2**63, rank]).generate_state(2, np.uint32)
    m = cfg["materials"]
    youngs, poissons, damping = sides.port("envs.soft_body").example_materials(
        cfg["num_envs"], m["youngs"], m["poissons"], seed=int(state[0]) << 32 | int(state[1]))
    return {"youngs": youngs, "poissons": poissons, "damping": damping}


def _program(cfg, traffic, inputs, device) -> Cell:
    sim = sides.port("envs.soft_body").soft_body_sim(
        cfg["num_envs"], device=device, height=cfg["drop_height"], materials=False)
    per_env = {f"soft_{k}": torch.as_tensor(inputs[k], device=device)
               for k in ("youngs", "poissons", "damping")}
    sim.params = sim.params._replace(**{k: v[:, None].expand_as(getattr(sim.params, k)).contiguous()
                                        for k, v in per_env.items()})
    stepper, actions, params, origins = sim.stepper, sim.actions, sim.params, sim.env_origins

    def work(state):
        """The shape of the XPBD solve's work (harness/xpbd_bound.py)."""
        w = sim.scene.soft
        return {"soft.work": {"envs": cfg["num_envs"], "verts": w.num_verts, "tets": w.num_tets,
                              "colliders": len(w.col_kind), "iterations": stepper.soft.iters,
                              "substeps": stepper.substeps}}

    return Cell(
        envs=cfg["num_envs"], starts=[sim.state],
        step=lambda s: (stepper.rollout(s, actions, params, 1), ()),
        fields=lambda s, out: ref.compared(s, origins, cfg["dt"]),
        episode=traffic["episode_steps"], counts=work,
        handoff=lambda s: ref.State(s.soft_pos, s.soft_vel, s.dof_pos, s.dof_vel),
    )


def _reference(cfg, traffic, inputs, device) -> Cell:
    press = ref.SoftPress(cfg, ROOT, (inputs["youngs"], inputs["poissons"], inputs["damping"]),
                          device)
    return Cell(envs=cfg["num_envs"], starts=[press.start()], step=press.step,
                fields=press.fields, episode=traffic["episode_steps"])


def build(cfg, traffic, inputs, device, impl="program", rank=0, world=1):
    if impl == "program":
        return _program(cfg, traffic, inputs, device)
    return sides.reference_cell(_reference(cfg, traffic, inputs, device), impl)


def reference(cfg, traffic, inputs, device, rank=0, world=1):
    return _reference(cfg, traffic, inputs, device)
