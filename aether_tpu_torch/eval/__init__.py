"""Evaluation helpers; so far only the host-side work sharding (``sharding``)."""
