"""Scans, smoothers and the plane-layout algebra."""
