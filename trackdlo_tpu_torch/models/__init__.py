"""Tracker models of the port."""
