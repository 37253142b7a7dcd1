"""Small sizes of the cells for the CPU tests."""

import copy

ENGINE = {"trials": 10, "warmup_rows": [3], "check": {"decisions": 4}}
#: the shared8 file's traffic as one job on its own ``BOSuggester``: every GP
#: decision refits (the traffic of the engine cell kept for later)
ONE_JOB = {"jobs": 1, "service": None, "stagger": False}
ENGINE_CONF = {"engine": {"slice": {"num_samples": 24, "burn_in": 12, "thin": 3},
                          "acq": {"num_anchors": 64, "refine_steps": 5}}}


def tiny_lm(conf: dict, compute: str = "float32") -> dict:
    conf = copy.deepcopy(conf)
    conf["model"].update(vocab_size=97, d_model=64, num_layers=2, num_heads=4, num_kv_heads=2,
                         head_dim=16, compute_dtype=compute)
    conf["model"]["moe"].update(num_experts=4, top_k=2, d_expert=32)
    return conf


LM = {"global_batch": 4, "seq_len": 16, "microbatches": 2}
