"""What every entry shares: the cell's files, the program's config, the
weights from the seed, exact float32 for the reference, the device."""
import contextlib
import json
import subprocess
from pathlib import Path

import torch

# the benchmark folder; ROOT is where the files are looked up (the CPU
# tests point it at a tiny copy)
BENCH_ROOT = Path(__file__).resolve().parents[1]
ROOT = BENCH_ROOT


def load_json(kind, name):
    """benchmark/<kind>/<name>.json, found by name."""
    path = ROOT / kind / (name + '.json')
    if not path.is_file():
        raise FileNotFoundError('no %s named %r (%s)' % (kind[:-1], name,
                                                         path))
    return json.loads(path.read_text())


def load_cell(name):
    """(workload, configuration) of a cell: the workload file and the
    configuration file it names."""
    work = load_json('workloads', name)
    return work, load_json('configs', work['config'])


def program_cfg(model_cfg, tag):
    """The port's attribute-dict config of a configuration's model dict,
    over the port's defaults, as its yaml loader builds it."""
    from pcdet_tpu_torch import config
    cfg = config.get_default_cfg()
    cfg.update(config.EDict(json.loads(json.dumps(model_cfg))))
    cfg.TAG = tag
    config.cfg_preprocess(cfg)
    return cfg


@contextlib.contextmanager
def exact_f32():
    """Float32 matmuls and convolutions without TF32, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def make_weights(spec, seed, device, zero_bias=('rpn_head.conv_cls.bias',)):
    """Weights of `spec` (`reference.net.RefModel.spec`) from `seed`, made on
    `device` by one generator in one draw: U(-1, 1) / sqrt(fan_in) for
    weights and biases (torch's default bound), BatchNorm at weight 1,
    bias 0, running mean 0, running variance 1; `zero_bias` set to 0 (the
    class head's bias, so that scores pass SCORE_THRESH and NMS gets
    candidates)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    drawn = [(n, s, f) for n, s, kind, f in spec if kind in ('w', 'b')]
    total = sum(int(torch.Size(s).numel()) for _, s, _ in drawn)
    flat = torch.rand(total, generator=gen, device=device) * 2 - 1
    out, at = {}, 0
    for name, shape, fan_in in drawn:
        n = int(torch.Size(shape).numel())
        out[name] = flat[at:at + n].view(shape) / fan_in ** 0.5
        at += n
    for name, shape, kind, _ in spec:
        if kind != 'bn':
            continue
        if name.endswith('num_batches_tracked'):
            out[name] = torch.zeros((), dtype=torch.long, device=device)
        elif name.endswith(('.weight', '.running_var')):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    for name in zero_bias:
        out[name] = torch.zeros_like(out[name])
    return out


def calibrate(ref, params, points, mask):
    """Running statistics and head scales as a trained model's: each
    BatchNorm takes the batch mean and variance that it meets in the
    reference's eval-caps forward over the calibration scans (layer by
    layer, each layer fed the normalised output of the one before); then
    each head's output channels are scaled to HEAD_STD over those scans."""
    stats = {}
    with torch.no_grad(), exact_f32():
        ref.forward(params, points, mask, train=False, mode='calib',
                    stats=stats)
    for name, (mean, var) in stats.items():
        params[name + '.running_mean'] = mean.contiguous()
        params[name + '.running_var'] = var.contiguous()
    with torch.no_grad(), exact_f32():
        out = ref.forward(params, points, mask, train=False)
    # the heads scaled so that each output channel spreads as a trained
    # head's would over these scans: box codes centred with a standard
    # deviation of HEAD_STD['box'] (anchor-sized boxes), class and direction
    # logits at HEAD_STD's; the class bias stays 0
    b, na = points.shape[0], ref.num_anchors
    for head, key in (('conv_box', 'box'), ('conv_cls', 'cls'),
                      ('conv_dir_cls', 'dir')):
        y = out[key].reshape(b, -1, na * out[key].shape[-1])
        mean, std = y.mean((0, 1)), y.std((0, 1))
        scale = HEAD_STD[key] / torch.clamp(std, min=1e-6)
        w, bias = 'rpn_head.%s.weight' % head, 'rpn_head.%s.bias' % head
        params[w] = params[w] * scale.view(-1, 1, 1, 1)
        shift = mean if key == 'box' else torch.zeros_like(mean)
        params[bias] = (params[bias] - shift) * scale
    return params


HEAD_STD = {'box': 0.5, 'cls': 1.0, 'dir': 1.0}


def device_info(device, count):
    """The card's name, the run's peak of allocated memory and, from
    nvidia-smi, the power limit (the CPU tests: the platform alone)."""
    if device.type != 'cuda':
        return {'platform': device.type, 'kind': 'cpu', 'count': count,
                'memory_peak_bytes': 0}
    info = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
            'count': count,
            'memory_peak_bytes': int(torch.cuda.max_memory_allocated())}
    try:
        q = subprocess.run(
            ['nvidia-smi', '--query-gpu=power.limit', '--format=csv,noheader'],
            capture_output=True, text=True, timeout=20)
        info['power_limit'] = q.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        info['power_limit'] = 'unknown'
    return info


def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def reset_peak(device, reset=True):
    """Free the cached blocks; with `reset`, start the peak afresh."""
    if device.type == 'cuda':
        torch.cuda.empty_cache()
        if reset:
            torch.cuda.reset_peak_memory_stats()
