"""Visualisation: debug images, mesh export, the HTML and live viewers."""
