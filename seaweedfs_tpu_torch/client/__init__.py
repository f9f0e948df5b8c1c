"""Clients of the port: the master client (master_client.py), which the
volume server's cluster half uses for its lookups."""
