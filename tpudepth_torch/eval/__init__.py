"""Evaluation of the port: metrics and the GuideDepth-stack evaluator."""
