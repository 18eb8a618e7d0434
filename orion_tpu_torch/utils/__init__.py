"""Config overrides, tokenizer, device selection."""
