"""Training: the AdamW optimizer with its schedule, the train step, the
training loops, uptraining and the zero-shot evaluation hook."""
