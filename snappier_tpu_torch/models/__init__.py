"""Batched codec pipelines (:class:`SnappyCodec`)."""
