"""Driver of the configuration balls-1080: examples/1080_balls_of_solitude.py
--all_collisions, one collision world of 36 pyramids x 30 balls whose
contacts the port's sphere-world kernel solves (`envs/balls.py::BallsEnv`)
on the program's side, reference/balls.py on the reference's and the
control's. Each episode restarts from the start, as the example's R key
does; the pyramids' jitter is drawn from the seed."""
import numpy as np

from portbench.harness import sides
from portbench.harness.cell import Cell
from portbench.reference import balls as ref


def inputs(cfg, traffic, seed, device, rank=0):
    state = np.random.SeedSequence([seed % 2**63, rank]).generate_state(1, np.uint32)
    return {"pyramid_seed": int(state[0])}


def _program(cfg, traffic, inputs, device) -> Cell:
    env = sides.port("envs.balls").BallsEnv(
        num_worlds=cfg["worlds"], pyramids=cfg["pyramids"], base=cfg["base"],
        radius=cfg["radius"], seed=inputs["pyramid_seed"], device=device)
    stepper = env.sim.stepper

    def fields(state, out):
        """Per ball (the unit of the comparison), over every world."""
        f = {"pos": state.root_pos, "quat": state.root_quat, "vel": state.root_linvel,
             "angvel": state.root_angvel}
        if out is not None:
            f["contact_force"] = state.contact_force
        return {k: v.reshape(-1, v.shape[-1]) for k, v in f.items()}

    from test_isaacgym_tpu_torch.ops import _kernels

    def note():
        n = _kernels.launches.get("sphere_world", 0)
        return [f"sphere_world kernel launches: {n} since set-up began"]

    return Cell(
        envs=cfg["worlds"], starts=[env.sim.state], step=lambda s: (env.rollout_fn(1)(s), ()),
        fields=fields, episode=traffic["episode_steps"], note=note,
        handoff=lambda s: ref.State(s.root_pos, s.root_quat, s.root_linvel, s.root_angvel),
        spans=[(stepper, "step", "simulator"), (stepper.contact, "solve", "contact"),
               (sides.port("ops.sphere_world"), "solve", "sphere_world", True)],
    )


def _reference(cfg, traffic, inputs, device) -> Cell:
    pile = ref.BallPile(cfg, inputs["pyramid_seed"], device)
    return Cell(envs=cfg["worlds"], starts=[pile.start()], step=pile.step, fields=pile.fields,
                episode=traffic["episode_steps"])


def build(cfg, traffic, inputs, device, impl="program", rank=0, world=1):
    if impl == "program":
        return _program(cfg, traffic, inputs, device)
    return sides.reference_cell(_reference(cfg, traffic, inputs, device), impl)


def reference(cfg, traffic, inputs, device, rank=0, world=1):
    return _reference(cfg, traffic, inputs, device)
