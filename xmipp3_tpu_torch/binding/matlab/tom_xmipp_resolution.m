function st = tom_xmipp_resolution(img, ref, objectpixelsize)
%TOM_XMIPP_RESOLUTION FRC/DPR resolution curves between IMG and REF.
%Returns struct with freq (1/Angstrom), dpr, frc, frc_noise.
%Replaces tom_xmipp_resolution.cpp.
st = xmipp_matlab_bridge('resolution', struct('img', img, 'ref', ref, ...
    'objectpixelsize', objectpixelsize));
end
