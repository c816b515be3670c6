"""The prefill and decode steps the server runs."""
