from repro_torch.data.pipeline import (ASSET_TYPES, CENTROID_SEED,
                                       CONDITIONS, IGNORE, VQITask, lm_batch,
                                       lm_stream, vqi_batch,
                                       vqi_eval_accuracy, vqi_stream)

__all__ = ["ASSET_TYPES", "CENTROID_SEED", "CONDITIONS", "IGNORE", "VQITask",
           "lm_batch", "lm_stream", "vqi_batch", "vqi_eval_accuracy",
           "vqi_stream"]
