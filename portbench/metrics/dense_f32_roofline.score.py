"""dense_f32_roofline.score: the dense kernel's float32 mode over the traced
scoring window: every forward layer's least time from its work
(``work.dense_work``) over the kernel's device time, in percent."""

from portbench import devtime, work


def read(run):
    seconds, launches = devtime.kernel_seconds(run["trace"], "dense_fixed_kernel")
    if launches == 0:
        return None
    shapes = work.sequence_dense_shapes(run["config"], run["batch"], run["seq_len"])
    per_call = sum(work.bound_seconds(*work.dense_work(*s)) for s in shapes)
    return work.roofline_percent(run["steps"] * per_call, seconds)
