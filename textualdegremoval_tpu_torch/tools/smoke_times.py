"""Where `chip_smoke.py`'s time goes: the whole script, with each of its
phase functions timed.

Runs `chip_smoke.main` from the checkout's root with the functions named
in PHASES wrapped, each call printing `TIME <function> <s> (at <s>)`,
the seconds since this tool started, beside the script's own output.
Nested calls print too (a phase's `profile_device` inside its
`train_main_path`).  The spawned ranks of phases 38-41 run
chip_smoke's own, unwrapped functions.

    python -m textualdegremoval_tpu_torch.tools.smoke_times [--seed 0]
"""

from __future__ import annotations

import functools
import sys
import time
from pathlib import Path

PHASES = """kernel_vs_plain network_vs_cpu main_path backward_vs_plain
remat_vs_save train_main_path train_step_vs_cpu nafblock_vs_plain
flash_vs_plain towers_vs_reference generation_path flash_bwd_vs_plain
training_path f32_step_vs_plain chain_vs_plain chain_grad_vs_autograd
promptir_path gdfn_vs_plain gdfn_grad_vs_autograd mdta_vs_plain
module_eval_path module_train_path module_step_memory qkv_form_vs_plain
stencil_vs_plain probe_tool_runs promptir_train_path f32_train_steps
cli_yaml_runs dino_matcher family_vs_cpu family_eval_path
family_train_step diffir_forward diffir_cli keyed_archives
tiled_restoration fid_and_metrics _dist_reference _spawn_ranks
_diffir_reference _dist_cli window_vs_plain _spatial_reference
naf_window_vs_plain _family_spatial_reference family_spatial_check
_pool_spatial_reference pool_spatial_check
spatial_phases profile_device""".split()


def main(argv=None) -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import chip_smoke

    t_start = time.perf_counter()

    def timed(name, fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                now = time.perf_counter()
                print(f"TIME {name} {now - t0:.1f} s (at "
                      f"{now - t_start:.1f})", flush=True)
        return call

    for name in PHASES:
        setattr(chip_smoke, name, timed(name, getattr(chip_smoke, name)))
    return chip_smoke.main(argv)


if __name__ == "__main__":
    sys.exit(main())
