"""The decoder language model: parameter schemas, layers, attention, the model."""
