"""Host and torch ops of the port (boxes, anchors, geometry, NMS,
proposals, ROI align, detection refinement)."""
