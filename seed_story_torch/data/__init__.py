"""Data pipeline of the port: tokenizer, long-story datapipe, image transforms."""
