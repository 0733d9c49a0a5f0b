"""Evaluation datasets the port reads without OpenCV."""
