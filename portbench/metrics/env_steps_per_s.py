"""env_steps_per_s: envs (worlds) x steps completed in the window / the
window's wall seconds, ending in its synchronize (host clock)."""


def read(ctx):
    return ctx.envs * ctx.window.steps / ctx.window.wall_s
