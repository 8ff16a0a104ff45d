from duet_tpu_torch.eval.evaluate import EvalResult, evaluate_files, evaluate_callsets
