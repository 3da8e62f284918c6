/* Native Moving-MNIST sequence generator.
 *
 * High-throughput input-pipeline core for the on-the-fly Moving MNIST
 * dataset (backend "native"): renders bouncing-digit sequences directly into
 * a float32 THWC buffer. Same physics as the numpy generator
 * (datasets/mmnist_on_the_fly.py), but driven by a fast xorshift RNG seeded
 * by the item's index instead of numpy's PCG64: a distinct, documented RNG
 * stream, order-independent and safe to call from several threads.
 *
 * Built at first use by native/build.py with the system C compiler, into
 * one library with png_unfilter.c, and loaded with ctypes.
 */
#include <stdint.h>
#include <string.h>

typedef struct {
    uint64_t s;
} rng_t;

static inline uint64_t rng_next(rng_t *r) {
    /* xorshift64* */
    uint64_t x = r->s;
    x ^= x >> 12;
    x ^= x << 25;
    x ^= x >> 27;
    r->s = x;
    return x * 0x2545F4914F6CDD1DULL;
}

static inline int64_t rng_randint(rng_t *r, int64_t lo, int64_t hi_excl) {
    return lo + (int64_t)(rng_next(r) % (uint64_t)(hi_excl - lo));
}

/* bounce update for one axis; mirrors _move_digit */
static inline void move_axis(int *pos, int *speed, int img_size, int digit_size) {
    int p = *pos + *speed;
    if (p + digit_size > img_size) {
        int offset = p + digit_size - img_size;
        p = p - offset;
        *speed = -*speed;
    } else if (p < 0) {
        p = -p;
        *speed = -*speed;
    }
    /* a reflection can land past the OTHER edge when the free range
     * (img - digit) is smaller than |speed| (e.g. 28px digits, 32px frame);
     * without this clamp the blit below writes OUT OF BOUNDS. Mirrors the
     * numpy path's np.clip. */
    if (p < 0) p = 0;
    if (p > img_size - digit_size) p = img_size - digit_size;
    *pos = p;
}

/* Generates one sequence.
 * digits:   [n_digit_templates, digit_size, digit_size] uint8 templates
 * out:      [seq_len, img, img, channels] float32 (caller-allocated)
 * Returns 0 on success.
 */
int generate_sequence(const uint8_t *digits, int64_t n_templates, int digit_size,
                      int seq_len, int img_size, int channels, int num_digits,
                      int min_speed, int max_speed, uint64_t seed, float *out) {
    if (num_digits > 8 || digit_size > img_size) return 1;
    rng_t rng = {seed ? seed : 0x9E3779B97F4A7C15ULL};

    const uint8_t *tpl[8];
    int pos_y[8], pos_x[8], spd_y[8], spd_x[8];
    for (int d = 0; d < num_digits; d++) {
        tpl[d] = digits + (size_t)rng_randint(&rng, 0, n_templates)
                 * digit_size * digit_size;
        pos_x[d] = (int)rng_randint(&rng, 0, img_size - digit_size);
        pos_y[d] = (int)rng_randint(&rng, 0, img_size - digit_size);
        do { spd_x[d] = (int)rng_randint(&rng, -max_speed, max_speed + 1); }
        while (spd_x[d] > -min_speed && spd_x[d] < min_speed);
        do { spd_y[d] = (int)rng_randint(&rng, -max_speed, max_speed + 1); }
        while (spd_y[d] > -min_speed && spd_y[d] < min_speed);
    }

    size_t frame_elems = (size_t)img_size * img_size * channels;
    memset(out, 0, sizeof(float) * frame_elems * seq_len);

    for (int t = 0; t < seq_len; t++) {
        float *frame = out + (size_t)t * frame_elems;
        for (int d = 0; d < num_digits; d++) {
            move_axis(&pos_y[d], &spd_y[d], img_size, digit_size);
            move_axis(&pos_x[d], &spd_x[d], img_size, digit_size);
            const uint8_t *img = tpl[d];
            for (int dy = 0; dy < digit_size; dy++) {
                int y = pos_y[d] + dy;
                float *row = frame + ((size_t)y * img_size + pos_x[d]) * channels;
                for (int dx = 0; dx < digit_size; dx++) {
                    float v = img[dy * digit_size + dx] * (1.0f / 255.0f);
                    for (int ch = 0; ch < channels; ch++) {
                        float acc = row[dx * channels + ch] + v;
                        row[dx * channels + ch] = acc > 1.0f ? 1.0f : acc;
                    }
                }
            }
        }
    }
    return 0;
}

/* Batch variant: fills [n_seqs, seq_len, img, img, channels]; per-sequence
 * seeds derived from base_seed so generation is order-independent and
 * parallelizable by the caller. */
int generate_batch(const uint8_t *digits, int64_t n_templates, int digit_size,
                   int n_seqs, int seq_len, int img_size, int channels,
                   int num_digits, int min_speed, int max_speed,
                   uint64_t base_seed, float *out) {
    size_t seq_elems = (size_t)seq_len * img_size * img_size * channels;
    for (int i = 0; i < n_seqs; i++) {
        int rc = generate_sequence(digits, n_templates, digit_size, seq_len,
                                   img_size, channels, num_digits, min_speed,
                                   max_speed, base_seed + 0x9E3779B9u * (i + 1),
                                   out + (size_t)i * seq_elems);
        if (rc) return rc;
    }
    return 0;
}
