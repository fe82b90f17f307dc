"""Distributed helpers. Only ``resilience.RetryPolicy`` is here, for the
serving client's retry; the collectives are ROADMAP A.8."""
