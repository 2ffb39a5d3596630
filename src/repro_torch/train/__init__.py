"""Training: AdamW, schedules, the train step and the loop."""
