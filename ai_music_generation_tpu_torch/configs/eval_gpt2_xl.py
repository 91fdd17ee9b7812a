# experiment config: eval_gpt2_xl (value parity with ref nanoGPT/config/eval_gpt2_xl.py)
batch_size = 8
eval_iters = 500
eval_only = True
wandb_log = False
init_from = 'gpt2-xl'
