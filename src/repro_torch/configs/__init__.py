"""Model configurations of the language-model serving path (``base``)."""
