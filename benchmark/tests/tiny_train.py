"""The training cell cut down to a size the CPU steps in seconds: the
recipe's flags with narrow networks (cbase 512, cmax 16), 128² data, a
16² neural render, minibatch-std groups of 2, every block in f32, and
the comparison on step 0 (every phase), for the harness's own tests only."""

TINY_FLAGS = ["--cbase", "512", "--cmax", "16", "--mbstd-group", "2",
              "--neural_rendering_resolution_initial", "16",
              "--sr_num_fp16_res", "0", "--d_num_fp16_res", "0"]


def overrides(cell, steps=(0,)):
    """Overrides of `harness.train.measure` for the training cell `cell`."""
    return {"config": {"flags": cell["config"]["flags"] + TINY_FLAGS},
            "traffic": {"data": {"images": 8, "resolution": 128, "blobs": 4},
                        "warmup_steps": 0, "trace_steps": 1,
                        "compare": {"steps": list(steps)}}}
