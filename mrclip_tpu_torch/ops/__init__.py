"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version."""


def launch_counts() -> dict:
    """Every kernel's launches since its module's last `reset_launches`, by
    kernel name (a wrapper counts a launch of its kernel on the card, never
    a call of its plain version on the CPU)."""
    from . import dw_conv as dc
    from . import flash_attn as fl
    from . import fused_attn as fa
    from . import pallas_loss as pl

    return {"packed_attn_fwd": fa.launches, "packed_attn_bwd": fa.bwd_launches,
            "packed_attn_rope_fwd": fa.rope_launches,
            "packed_attn_rope_bwd": fa.rope_bwd_launches,
            "grouped_attn_fwd": fa.grouped_launches, "grouped_attn_bwd": fa.grouped_bwd_launches,
            "flash_attn_fwd": fl.launches, "flash_attn_bwd": fl.bwd_launches, **pl.launches,
            **dc.launches}


def launch_counts_by_width() -> dict:
    """The attention kernels' launches since their module's last
    `reset_launches`, by kernel name and head dim: {name: {d: count}}."""
    from . import flash_attn as fl
    from . import fused_attn as fa

    kernels = ((fa, {"launches": "packed_attn_fwd", "bwd_launches": "packed_attn_bwd",
                     "rope_launches": "packed_attn_rope_fwd",
                     "rope_bwd_launches": "packed_attn_rope_bwd",
                     "grouped_launches": "grouped_attn_fwd",
                     "grouped_bwd_launches": "grouped_attn_bwd"}),
               (fl, {"launches": "flash_attn_fwd", "bwd_launches": "flash_attn_bwd"}))
    out: dict = {}
    for module, names in kernels:
        for (counter, d), n in module.width_launches.items():
            out.setdefault(names[counter], {})[d] = n
    return out


def launch_counts_by_route() -> dict:
    """The attention kernels' launches since their module's last
    `reset_launches`, by kernel name, head dim and route
    (`fused_attn.FWD_ROUTES`, `BWD_ROUTES`): {name: {d: {route: count}}}."""
    from . import flash_attn as fl
    from . import fused_attn as fa

    kernels = ((fa, {"launches": "packed_attn_fwd", "bwd_launches": "packed_attn_bwd",
                     "rope_launches": "packed_attn_rope_fwd",
                     "rope_bwd_launches": "packed_attn_rope_bwd",
                     "grouped_launches": "grouped_attn_fwd",
                     "grouped_bwd_launches": "grouped_attn_bwd"}),
               (fl, {"launches": "flash_attn_fwd", "bwd_launches": "flash_attn_bwd"}))
    out: dict = {}
    for module, names in kernels:
        for (counter, d, route), n in module.route_launches.items():
            out.setdefault(names[counter], {}).setdefault(d, {})[route] = n
    return out


def launches_since(before: dict) -> dict:
    """The kernels launched since the `launch_counts()` snapshot `before`,
    with their counts."""
    return {k: v - before.get(k, 0) for k, v in launch_counts().items() if v != before.get(k, 0)}
