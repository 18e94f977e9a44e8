"""A cell cut down to a size the CPU runs in seconds: widths, resolutions,
depth steps and batch, for the harness's own tests only."""

TINY_GENERATOR = {
    "img_resolution": 128, "channel_base": 1024, "channel_max": 32,
    "sr_num_fp16_res": 0, "num_fp16_res": 0, "conv_clamp": None,
    "sr_kwargs": {"channel_base": 1024, "channel_max": 32},
    "mapping_kwargs": {"in_resolution": 128, "encoder_channel_base": 1 / 128,
                       "encoder_num_fp16_res": 0},
    "rendering_kwargs": {"image_resolution": 128,
                         "superresolution_module": "SuperresolutionHybrid2X",
                         "superresolution_module_semantic": "SuperresolutionHybrid2X_semantic",
                         "depth_resolution": 12, "depth_resolution_importance": 12,
                         "frustum_depth_steps": 8, "frustum_chunk": 8,
                         "frustum_bf16": False},
}


def overrides(cell_name, batch=2):
    """Overrides of `harness.generate.measure` for cell `cell_name`."""
    path = {"seg2cat-batch32": "serving", "seg2cat-serve-b1": "serving",
            "edge2car-batch32": "apps"}[cell_name]
    return {"config": {"generator": TINY_GENERATOR,
                       "paths": {path: {"generator": TINY_GENERATOR, "nrr": 16}},
                       "data": {"resolution": 128}},
            "traffic": {"batch": batch, "pool": 4, "phases": 4, "units": 8, "warmup_units": 1,
                        "trace_units": 1, "tf32": False,
                        "compare": {"units": 1, "among": 1, "block": 2}}}
