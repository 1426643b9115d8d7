"""Realtime sessions, the multi-avatar batch and the serving daemon."""
