"""Serving layer of the port: the batched LM engine (:mod:`.engine`)."""
