"""Training (port of ``repro.training``): AdamW, the train step, the
synthetic token pipeline and checkpoints."""
