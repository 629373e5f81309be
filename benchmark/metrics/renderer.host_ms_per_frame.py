"""The renderer's host time a frame: the benchmark's spans around
``render_sample`` (the counter FSM, the camera's copy, the launch,
``finish_frame``) and ``display`` (``screen_output``), before the sync, in ms."""


def read(ctx):
    sample_s, frames = ctx.spans.total("render_sample")
    display_s, _ = ctx.spans.total("display")
    if not frames or ctx.cell.mix["kind"] != "interactive":
        return None
    return 1e3 * (sample_s + display_s) / frames
