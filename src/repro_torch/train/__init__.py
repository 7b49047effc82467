"""The training plane: ``optim`` (AdamW, Adafactor, the warmup-cosine
schedule) and ``step`` (the train state and the train step)."""
