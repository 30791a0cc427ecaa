"""Interactive multimodal chat CLI (port of llavamod_tpu/serve/cli.py).

Mirror of the reference's `serve/cli.py:26-123` user experience (load model,
infer conversation template from the name, one image, chat loop, streaming
print): one prefill (kernel K1 on the card) and a decode loop over the KV
cache (kernel K2), no deepspeed launcher.  Turns are read with input(), so
a script can pipe them in on stdin; an empty line or end of input ends the
chat.

Usage:
  python -m llavamod_tpu_torch.serve.cli --model-path <dir> --image-file <img>

The model goes to the card unless --device (or `main(..., device=...)`)
asks for another; `main(..., tokenizer=...)` takes a tokenizer object
instead of the checkpoint's HF tokenizer files.
"""

from __future__ import annotations

import argparse

import numpy as np


def load_image(image_file: str):
    from PIL import Image

    if image_file.startswith(("http://", "https://")):
        raise RuntimeError("zero-egress environment: use a local image path")
    return Image.open(image_file).convert("RGB")


def build_parser(device: str = "cuda") -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="llavamod_tpu_torch.serve.cli")
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--model-base", default=None)
    ap.add_argument("--vision-path", default=None,
                    help="an HF CLIP or SigLIP directory: the tower of an HF "
                         "checkpoint directory, which holds none")
    ap.add_argument("--image-file", required=True)
    ap.add_argument("--conv-mode", default=None)
    ap.add_argument("--temperature", type=float, default=0.2)
    ap.add_argument("--max-new-tokens", type=int, default=512)
    ap.add_argument("--stream-chunk", type=int, default=8,
                    help="tokens decoded per chunk between prints "
                         "(0 = print only the full reply)")
    ap.add_argument("--quant", default="", choices=["", "int8"],
                    help="int8 = W8A8 serving (the counterpart of the "
                         "reference's --load-8bit)")
    ap.add_argument("--kv-cache-dtype", default="bfloat16",
                    choices=["bfloat16", "float32", "int8"])
    ap.add_argument("--device", default=device,
                    help="torch device of the model (default: the card)")
    return ap


def main(argv=None, tokenizer=None, device="cuda"):
    """Run the chat loop; returns the assistant's replies, in order."""
    args = build_parser(device).parse_args(argv)

    from llavamod_tpu_torch import conversation as conv_lib
    from llavamod_tpu_torch.constants import DEFAULT_IMAGE_TOKEN
    from llavamod_tpu_torch.eval.generate import VQARunner
    from llavamod_tpu_torch.generation import (
        GenerationConfig,
        decode_texts,
        generate,
        generate_stream,
        truncate_at_stops,
    )
    from llavamod_tpu_torch.models.builder import load_pretrained_model

    tokenizer, model, cfg, pp, _ = load_pretrained_model(
        args.model_path, args.model_base, device=args.device,
        tokenizer=tokenizer, vision_path=args.vision_path)
    if args.quant == "int8":
        from llavamod_tpu_torch.models.builder import quantize_for_serving

        model = quantize_for_serving(model)
        print("[load] int8-W8A8 serving quantization applied")
    template = args.conv_mode or conv_lib.infer_template_name(args.model_path)
    print(f"[conv template: {template}]")

    conv = conv_lib.get_template(template)
    image = load_image(args.image_file)
    pixels = pp(image)
    runner = VQARunner(model, tokenizer, pp, template_name=template,
                       batch_size=1)
    eos_ids, stop_seqs = runner.stopping(())
    gcfg = GenerationConfig(
        max_new_tokens=args.max_new_tokens, temperature=args.temperature,
        eos_token_ids=eos_ids, stop_sequences=stop_seqs,
        pad_token_id=tokenizer.pad_token_id or 0,
        cache_dtype=args.kv_cache_dtype)

    replies = []
    first_turn = True
    while True:
        try:
            user = input(f"{conv.roles[0]}: ")
        except EOFError:
            break
        if not user:
            break
        if first_turn:
            user = DEFAULT_IMAGE_TOKEN + "\n" + user
            first_turn = False
        conv.append(conv.roles[0], user)
        conv.append(conv.roles[1], None)
        prompt = conv.render()

        batch = runner._encode_batch([prompt], [pixels])
        if args.stream_chunk <= 0:
            gen_ids = generate(model, batch, gcfg)
            text = decode_texts(tokenizer, gen_ids,
                                pad_token_id=gcfg.pad_token_id)[0].strip()
            print(f"{conv.roles[1]}: {text}")
        else:
            # Streaming decode (TextStreamer parity, reference
            # serve/cli.py:99-108): print incrementally per decoded chunk.
            # Hold back `win` trailing tokens (the longest stop string)
            # so a stop sequence is never partially printed; the held-back
            # tail is printed after final stop-truncation.
            win = max([len(s) for s in gcfg.stop_sequences], default=0)
            print(f"{conv.roles[1]}: ", end="", flush=True)
            chunks = []
            printed = ""
            for toks in generate_stream(model, batch, gcfg,
                                        chunk=args.stream_chunk):
                chunks.append(toks)
                ids = np.concatenate(chunks, axis=1)
                visible = ids[:, :max(ids.shape[1] - win, 0)]
                cur = decode_texts(tokenizer, visible,
                                   pad_token_id=gcfg.pad_token_id)[0]
                if cur.startswith(printed):
                    print(cur[len(printed):], end="", flush=True)
                    printed = cur
            gen_ids = truncate_at_stops(np.concatenate(chunks, axis=1), gcfg)
            full = decode_texts(tokenizer, gen_ids,
                                pad_token_id=gcfg.pad_token_id)[0]
            # remainder beyond what was streamed (held-back stop window)
            if full.startswith(printed):
                print(full[len(printed):], flush=True)
            else:
                # rare BPE boundary mismatch: reprint the clean final text
                print(f"\n[full reply] {full.strip()}")
            text = full.strip()
        conv.messages[-1][1] = text
        replies.append(text)
    return replies


if __name__ == "__main__":
    main()
