"""The architecture registry and the recsys serve/retrieval steps."""
