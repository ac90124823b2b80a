"""Training: the AdamW optimizer with its schedule, and the train step."""
