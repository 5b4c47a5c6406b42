"""attn_roofline.score: the attention forward kernel's share of its roofline
over the traced scoring window: its least time from its work
(``work.attention_work``) over its device time, in percent."""

from portbench import devtime, work


def read(run):
    seconds, launches = devtime.kernel_seconds(run["trace"], "flash_attention_fwd_kernel")
    if launches == 0:
        return None
    cfg = run["config"]
    shape = work.sequence_attention_shape(cfg, run["batch"], run["seq_len"])
    per_call = cfg["n_layers"] * work.bound_seconds(*work.attention_work(*shape))
    return work.roofline_percent(run["steps"] * per_call, seconds)
